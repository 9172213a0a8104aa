"""Model configurations of the port."""
from repro_torch.configs.cnn import CNN_ARCHS, get_cnn_config, smoke_cnn_config  # noqa: F401
from repro_torch.configs.registry import ARCHS, get_config, smoke_config  # noqa: F401
from repro_torch.configs.shapes import SHAPES, cell_runnable, input_specs, make_batch  # noqa: F401
