from gloo_tpu_torch.models.mlp import MLP
from gloo_tpu_torch.models.transformer import Transformer, TransformerConfig

__all__ = ["MLP", "Transformer", "TransformerConfig"]
