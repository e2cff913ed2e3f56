from dasa_tpu_torch.ops.adain import adain_channel_gate  # noqa: F401
from dasa_tpu_torch.ops.lstm import (  # noqa: F401
    bilstm_scan,
    lstm_scan,
    lstm_scan_bwd,
)
from dasa_tpu_torch.ops.shift_attention import shift_attend  # noqa: F401

_WRAPPERS = (lstm_scan, bilstm_scan, lstm_scan_bwd, adain_channel_gate,
             shift_attend)


def kernel_launches() -> dict:
    """Launch counts of the CUDA kernels' wrappers, by wrapper name."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def reset_kernel_launches() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
