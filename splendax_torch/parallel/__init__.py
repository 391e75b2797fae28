"""Multi-process training over `torch.distributed`: the counterpart of
`splendax/parallel/` (`multihost`, `mesh`), plus the explicit collectives
(`collectives`) that GSPMD inserts for the JAX package, the multi-rank dry
run (`dryrun`) and the env-fleet scaling bench (`bench_scaling`)."""
