"""The twins of the JAX package's ``examples/``: one module per example,
each run as ``python -m repro_torch.examples.<name>`` on the CUDA card, or
on the CPU with ``--device cpu``.  Each has a ``main(device, ...)`` that
takes the reference's inputs as numpy where its draws come from JAX's PRNG
(which the port does not re-implement; without them the draws come from
``torch.Generator().manual_seed(0)``), prints what the reference prints in
the same format, and returns those records.

- :mod:`.quickstart`: two-level H-SGD, one class per worker.
- :mod:`.multilevel_hsgd`: three levels against the extremes (Fig. E.8).
- :mod:`.population_hsgd`: 10^6 virtual clients in 8 slots.
- :mod:`.serve_decode`: prefill and decode on every cache type.
- :mod:`.train_hsgd`: ``repro_torch.launch.train`` with the reference's
  argv.

``examples/plan_deployment.py``'s twin is
:mod:`repro_torch.experiments.plan_deployment`.
"""
