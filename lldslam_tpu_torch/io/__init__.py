"""Counterpart of lldslam_tpu.io."""
