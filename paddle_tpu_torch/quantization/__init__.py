"""Weight-only quantized serving layers of the port.

Counterpart of the serving half of ``paddle_tpu/quantization``:
``weight_only_int4`` / ``Int4Linear`` (packed int4 weights, kernel row 7,
``csrc/int4_matmul.cu``) and ``weight_only_int8`` / ``Int8Linear`` (int8
weights, the dynamic activation quantize of kernel row 8 and
``torch._int_mm``). PTQ, QAT and ``Int8Conv2D`` come with later slices.

    from paddle_tpu_torch.quantization import weight_only_int4
    qmodel = weight_only_int4(model, group=128, inplace=False)
    engine = ServingEngine(qmodel, kv_layout="contiguous")
"""
from ._swap import swap_layers
from .int4_layers import (Int4Linear, pack_rows_int4, quantize_int4_rows,
                          weight_only_int4)
from .int8_layers import Int8Linear, weight_only_int8

__all__ = ["Int4Linear", "Int8Linear", "pack_rows_int4",
           "quantize_int4_rows", "swap_layers", "weight_only_int4",
           "weight_only_int8"]
