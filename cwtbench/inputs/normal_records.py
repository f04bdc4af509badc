"""Records of independent standard normal samples (white noise, whose
expected wavelet power is the same at every scale), drawn on the device
from the seed with one ``torch.Generator`` in one call.

Parameters: ``records`` (how many distinct records the calls cycle
through) and ``n0`` (samples a record)."""
import torch


def make(params: dict, seed: int, device: str) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    x = torch.randn((params["records"], params["n0"]), generator=gen,
                    device=device, dtype=torch.float32)
    return {"x": x}
