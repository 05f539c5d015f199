"""Counterpart of lldslam_tpu.frontend."""
