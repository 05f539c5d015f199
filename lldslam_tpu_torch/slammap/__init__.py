"""Counterpart of lldslam_tpu.slammap."""
