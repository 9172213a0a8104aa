"""Model configurations of the port."""
from repro_torch.configs.cnn import CNN_ARCHS, get_cnn_config, smoke_cnn_config  # noqa: F401
