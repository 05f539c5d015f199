"""Counterpart of lldslam_tpu.loop: place recognition and loop closing."""
