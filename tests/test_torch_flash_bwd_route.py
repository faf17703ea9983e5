"""The rule that picks K5's backward kernels (``_bwd_route``), on the CPU:
every branch and every refusal.  bf16 at D <= 192 runs the wgmma kernels,
fed by TMA where D and Dv are multiples of 8 and q, k, v and dO start on
16 bytes, else by plain loads; f32 at any D, and bf16 above 192, the
CUDA-core kernels.  The kernels themselves run only on the card
(``tests/test_torch_gpu.py``); a CPU backward launches none of them."""

import importlib

import pytest
import torch

fa = importlib.import_module("repro_torch.kernels.flash_attention")


@pytest.mark.parametrize("d,dv", [(1, 1), (8, 8), (24, 16), (64, 64),
                                  (64, 48), (80, 80), (128, 128), (128, 64),
                                  (192, 128), (192, 192), (160, 160)])
def test_bf16_aligned_widths_take_wgmma_tma(d, dv):
    want = "wgmma-tma" if d % 8 == 0 and dv % 8 == 0 else "wgmma-ldst"
    assert fa._bwd_route(torch.bfloat16, d, dv, True) == want


@pytest.mark.parametrize("d,dv", [(100, 36), (64, 36), (100, 96), (33, 33),
                                  (191, 128), (1, 1)])
def test_bf16_rows_tma_cannot_describe_take_wgmma_ldst(d, dv):
    assert fa._bwd_route(torch.bfloat16, d, dv, True) == "wgmma-ldst"


@pytest.mark.parametrize("d,dv", [(64, 64), (128, 128), (192, 128)])
def test_bf16_misaligned_bases_take_wgmma_ldst(d, dv):
    assert fa._bwd_route(torch.bfloat16, d, dv, False) == "wgmma-ldst"


@pytest.mark.parametrize("d,dv", [(193, 193), (200, 200), (256, 256),
                                  (256, 128)])
@pytest.mark.parametrize("aligned", [True, False])
def test_bf16_beyond_192_takes_the_cuda_cores(d, dv, aligned):
    assert fa._bwd_route(torch.bfloat16, d, dv, aligned) == "cuda-cores"


@pytest.mark.parametrize("d,dv", [(16, 16), (64, 64), (100, 36), (128, 128),
                                  (192, 128), (256, 256)])
@pytest.mark.parametrize("aligned", [True, False])
def test_f32_takes_the_cuda_cores_at_every_width(d, dv, aligned):
    assert fa._bwd_route(torch.float32, d, dv, aligned) == "cuda-cores"


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_other_dtypes_raise(dtype):
    with pytest.raises(TypeError):
        fa._bwd_route(dtype, 64, 64, True)


@pytest.mark.parametrize("d,dv", [(0, 0), (64, 0), (64, 65), (257, 128),
                                  (300, 300)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_widths_out_of_bounds_raise(d, dv, dtype):
    with pytest.raises(ValueError):
        fa._bwd_route(dtype, d, dv, True)


def test_routes_are_the_c_entry_points_codes():
    """The wrapper passes a route as its index in BWD_ROUTES:
    flash_bwd_launch reads 0 as the CUDA cores, 1 as wgmma-tma, 2 as
    wgmma-ldst."""
    assert fa.BWD_ROUTES == ("cuda-cores", "wgmma-tma", "wgmma-ldst")
    assert fa.WGMMA_MAX_HEAD_DIM == 192 <= fa.MAX_HEAD_DIM


def test_a_cpu_backward_launches_no_route():
    rng = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 9, 16, generator=rng, requires_grad=True)
    kv = torch.randn(1, 1, 9, 16, generator=rng, requires_grad=True)
    before = dict(fa.ROUTE_LAUNCHES)
    fa.flash_attention(q, kv, kv).sum().backward()
    assert dict(fa.ROUTE_LAUNCHES) == before
    assert q.grad.shape == q.shape and kv.grad.shape == kv.shape
