from repro_torch.models import simple as _simple
from repro_torch.models import transformer as _lm
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.model import build_model
from repro_torch.models.simple import SimpleConfig, SimpleModel
from repro_torch.models.transformer import DecoderLM


def _is_lm(tree) -> bool:
    return isinstance(tree, dict) and "embed" in tree


def params_from_numpy(tree, device="cuda"):
    """The reference's params (numpy leaves, e.g. from ``jax.device_get``)
    as the port's tensors on ``device``: an LM's tree (it holds ``embed``;
    decoder-only or encoder-decoder, MoE blocks included) leaf for leaf
    through :func:`repro_torch.models.transformer.params_from_numpy`,
    bfloat16 included, a SimpleModel's through
    :func:`repro_torch.models.simple.params_from_numpy`."""
    if _is_lm(tree):
        return _lm.params_from_numpy(tree, device)
    return _simple.params_from_numpy(tree, device)


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy`."""
    if _is_lm(tree):
        return _lm.params_to_numpy(tree)
    return _simple.params_to_numpy(tree)


__all__ = ["DecoderLM", "EncDecLM", "SimpleConfig", "SimpleModel",
           "build_model", "params_from_numpy", "params_to_numpy"]
