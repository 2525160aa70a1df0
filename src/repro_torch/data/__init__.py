from repro_torch.data.pipeline import (
    DataConfig,
    SyntheticLM,
    data_iterator,
    make_data_config,
)

__all__ = ["DataConfig", "SyntheticLM", "data_iterator", "make_data_config"]
