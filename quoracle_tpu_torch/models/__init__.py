"""Model layer of the PyTorch port: catalog, tokenizer, grammar, forward,
sampling, the generate engine and the serving backend."""

from quoracle_tpu_torch.models.config import (  # noqa: F401
    ModelConfig, get_model_config, list_models, register_model,
)
