"""repro_torch — the H-SGD system in PyTorch, for one NVIDIA H100.

A module-by-module counterpart of ``repro`` (the JAX package, which stays
the reference): ``repro_torch.core.topology`` mirrors
``repro.core.topology`` and so on, with the same public names.  This
package imports ``torch``, never ``jax`` and nothing of ``repro``.

Entry points (``SimpleModel.init``, ``params_from_numpy``, ``HSGD.init``,
``HSGD.init_from_params``) run on ``cuda`` unless the caller passes
``device="cpu"``; asking for ``cuda`` where there is none raises.
"""
