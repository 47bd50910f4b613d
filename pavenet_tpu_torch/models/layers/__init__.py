from .positional_encoding import (SinePositionalEncoding,
                                  sine_positional_encoding)
from .transformer import FFN, MLP, Dropout, MultiheadAttention

__all__ = ["SinePositionalEncoding", "sine_positional_encoding", "FFN",
           "MLP", "Dropout", "MultiheadAttention"]
