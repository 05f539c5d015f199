"""Counterpart of lldslam_tpu.pipeline."""
