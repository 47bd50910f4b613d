from .positional_encoding import sine_positional_encoding
from .transformer import FFN, MLP, Dropout, MultiheadAttention

__all__ = ["sine_positional_encoding", "FFN", "MLP", "Dropout",
           "MultiheadAttention"]
