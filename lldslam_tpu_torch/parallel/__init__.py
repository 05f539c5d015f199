"""Counterpart of lldslam_tpu.parallel: the synchronous multi-sequence
driver (`multi_seq.MultiSequenceDriver`). The pipelined driver and the
multi-device bundle adjustment (dist_schur, sharded_ba) are not ported."""
