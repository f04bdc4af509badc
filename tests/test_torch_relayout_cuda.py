"""cwt_stage_b's ablation variants (``cwt_stage_b_ablation``,
pycwt_torch/tools/relayout_experiment.py) on the card: each against its
plain PyTorch version, ``full`` bit for bit with ``cwt_stage_b``'s planes,
``memcopy`` exactly, and the launch counters.  They need an NVIDIA card and
nvcc, so they skip where there is none; ``python -m pytest --noconftest
tests/test_torch_relayout_cuda.py`` on the card runs them."""
import pytest
import torch

from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.tools import relayout_experiment as rx

#: bound of a variant against its plain version, relative to max|out|
BOUND = 1e-5
#: nfft -> scales: R1 = 128 (plan 16·8) and R1 = 1024 (16·16·4)
SHAPES = {1 << 14: 4, 1 << 20: 2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("variant", rx.VARIANTS)
@pytest.mark.parametrize("nfft", sorted(SHAPES), ids=["2^14", "2^20"])
def test_variant_matches_plain_version(cuda, nfft, variant):
    T = rx.make_t(nfft, SHAPES[nfft], seed=nfft, device=cuda)
    got = rx.ablated_stage_b(*T, nfft=nfft, variant=variant)
    ref = fc._stage_b_ablation_reference(*T, nfft=nfft, variant=variant)
    if variant == "memcopy":
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    else:
        err = max(float((got[0] - ref[0]).abs().max()), float((got[1] - ref[1]).abs().max()))
        assert err <= BOUND * float(torch.complex(*ref).abs().max())


@pytest.mark.parametrize("pow2", [8, 9, 14, 20, 22])
def test_full_is_stage_b_bit_for_bit(cuda, pow2):
    nfft = 1 << pow2
    T = rx.make_t(nfft, 2, seed=pow2, device=cuda)
    got = rx.ablated_stage_b(*T, nfft=nfft, variant="full")
    ref = fc.stage_b(*T, nfft=nfft, output="planes")
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_counters(cuda):
    """Each variant counts its own launches; cwt_stage_b's counter does not
    move when a variant runs."""
    nfft = 1 << 14
    T = rx.make_t(nfft, 2, device=cuda)
    for v in rx.LAUNCHES:
        rx.LAUNCHES[v] = 0
    stage_b = fc.KERNEL_LAUNCHES["cwt_stage_b"]
    for i, v in enumerate(rx.VARIANTS):
        for _ in range(i + 1):
            rx.ablated_stage_b(*T, nfft=nfft, variant=v)
    torch.cuda.synchronize()
    assert rx.LAUNCHES == {v: i + 1 for i, v in enumerate(rx.VARIANTS)}
    assert fc.KERNEL_LAUNCHES["cwt_stage_b"] == stage_b
