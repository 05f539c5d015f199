"""Counterpart of lldslam_tpu.viewer."""
