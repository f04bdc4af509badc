"""The process-wide f32 matmul settings that the pin checks set and put back:
``tests/test_torch_matmul_pin.py`` (CPU), ``tests/test_torch_matmul_pin_cuda.py``
and ``chip_smoke.py``'s ``phase_repairs`` (the card) import them; this
module imports no JAX.  Its own test checks that a setting made through
each API is put back."""
import pytest
import torch

#: (backend, operation) of every fp32_precision setting, parents first: a
#: parent's setter writes its children
FP32_SETTINGS = [("generic", "all"), ("cuda", "all"), ("cuda", "matmul"),
                 ("cuda", "conv"), ("cuda", "rnn"), ("mkldnn", "all"),
                 ("mkldnn", "matmul"), ("mkldnn", "conv"), ("mkldnn", "rnn")]

#: a caller's setting, through each API: the legacy setter and cuBLAS flag,
#: and the newer per-backend and generic fp32_precision
CALLERS = {
    "highest": lambda: torch.set_float32_matmul_precision("highest"),
    "high": lambda: torch.set_float32_matmul_precision("high"),
    "medium": lambda: torch.set_float32_matmul_precision("medium"),
    "allow_tf32": lambda: setattr(torch.backends.cuda.matmul, "allow_tf32", True),
    "fp32_precision_cuda_tf32": lambda: setattr(torch.backends.cuda.matmul,
                                                "fp32_precision", "tf32"),
    "fp32_precision_onednn_bf16": lambda: setattr(torch.backends.mkldnn.matmul,
                                                  "fp32_precision", "bf16"),
    "fp32_precision_generic_tf32": lambda: setattr(torch.backends, "fp32_precision",
                                                   "tf32"),
}


def state() -> dict:
    """Every fp32_precision setting as stored, and the legacy setting
    (which PyTorch refuses to read after some mixes of the two APIs)."""
    out = {f"{b}.{o}": torch._C._get_fp32_precision_getter(b, o)
           for b, o in FP32_SETTINGS}
    try:
        out["legacy"] = torch.get_float32_matmul_precision()
    except RuntimeError:
        out["legacy"] = None
    return out


def restore(saved: dict) -> None:
    """Put back a :func:`state`: the generic setting, the legacy one, then
    every per-backend setting as stored."""
    torch._C._set_fp32_precision_setter("generic", "all", saved["generic.all"])
    if saved["legacy"] is not None:
        torch.set_float32_matmul_precision(saved["legacy"])
    for b, o in FP32_SETTINGS:
        torch._C._set_fp32_precision_setter(b, o, saved[f"{b}.{o}"])


@pytest.mark.parametrize("caller", list(CALLERS))
def test_restore_puts_each_setting_back(caller):
    saved = state()
    CALLERS[caller]()
    assert state() != saved or caller == "highest"
    restore(saved)
    assert state() == saved
