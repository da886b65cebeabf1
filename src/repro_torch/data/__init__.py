from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM, to_device

__all__ = ["SyntheticConfig", "SyntheticLM", "to_device"]
