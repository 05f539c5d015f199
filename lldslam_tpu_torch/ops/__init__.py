"""Counterpart of lldslam_tpu.ops."""
