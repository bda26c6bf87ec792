from dynamo_tpu_torch.engine.engine import EngineConfig, TorchLlmEngine

__all__ = ["EngineConfig", "TorchLlmEngine"]
