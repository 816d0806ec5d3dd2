"""Mixed precision (counterpart of ``paddle_tpu/amp``): ``auto_cast``
and ``decorate`` with the reference's O1/O2 casting rules."""
from .auto_cast import (BLACK_LIST, WHITE_LIST, auto_cast, autocast_inputs,
                        decorate)

__all__ = ["BLACK_LIST", "WHITE_LIST", "auto_cast", "autocast_inputs",
           "decorate"]
