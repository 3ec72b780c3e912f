"""Probe entry points: the kernel-design probes of `benchmarks/experiments/`,
each runnable as `python -m crypto_rec_tpu_torch.experiments.<name>` on an
NVIDIA GPU.  The measuring code of each is a `run_*` function over tensors
(`_common.ProbeIndex`); `main()` builds the inputs on the card and raises
without one."""
