from repro_torch.serving.engine import DecodeEngine, GenerationResult

__all__ = ["DecodeEngine", "GenerationResult"]
