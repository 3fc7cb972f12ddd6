"""The port's hand-written CUDA kernels (``csrc/``), their wrappers and
their plain PyTorch versions (counterpart of ``repro.kernels``)."""
import torch


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record a call of kernel ``name``.

    No kernel of the port has a backward yet, as none of the reference's
    Pallas kernels has one (``jax.grad`` through them fails).  A kernel's
    output on the card carries no ``grad_fn``, so without this check a
    ``backward()`` would silently leave out every gradient that flows
    through it, while on the CPU the plain version would be differentiated.
    The wrappers therefore refuse on both devices alike."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the kernel has no backward, as the reference's Pallas "
            "kernels have none (LM training runs the plain path); call it "
            "under torch.no_grad() or torch.inference_mode(), or on tensors "
            "that do not require grad")
