"""Model zoo of the PyTorch port (the transformer LM so far)."""
from .transformer import get_transformer_lm, transformer_block  # noqa: F401
