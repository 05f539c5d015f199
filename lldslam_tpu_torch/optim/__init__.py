"""Counterpart of lldslam_tpu.optim."""
