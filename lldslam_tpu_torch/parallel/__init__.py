"""Counterpart of lldslam_tpu.parallel: the multi-sequence drivers
(`multi_seq`), the landmark-sharded and the observation-sharded bundle
adjustment on torch.distributed (`dist_schur`, `sharded_ba`) and the
spawner of a host's ranks (`ranks`)."""
