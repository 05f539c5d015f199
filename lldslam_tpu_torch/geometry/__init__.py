"""Counterpart of lldslam_tpu.geometry."""
