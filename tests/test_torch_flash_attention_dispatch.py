"""Which B6 kernel takes which inputs (``kernel.variant``) and how the
launches are counted (``ops.launches``), on the CPU.

``variant`` is a pure function of dtype, D, strides and alignment: the
wgmma/TMA kernel (``sm90``) takes bf16 with D a multiple of 8 in [8, 256],
D contiguous, 16-byte aligned bases and positive (B, S, H) strides that are
multiples of 8 elements (a dim of size 1 needs none); every other bf16 input
goes to the mma.sync kernel (``mma``), f32 to the SIMT kernel (``simt``).
G = Hq / Hkv never changes the kernel, only how the sm90 kernel pairs its
warpgroups.  The backward kernel follows the forward's (``bwd_variant``):
``bwd_sm90`` exactly after ``sm90``.  The launch itself needs the card
(``test_torch_kernels_cuda``, ``test_torch_train_cuda``).
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel, ops

BF16 = torch.bfloat16


def _qkv(b=1, sq=64, skv=64, hq=4, hkv=2, d=128, dtype=BF16):
    q = torch.zeros((b, sq, hq, d), dtype=dtype)
    k = torch.zeros((b, skv, hkv, d), dtype=dtype)
    return q, k, k.clone()


@pytest.mark.parametrize("d,want", [(8, "sm90"), (16, "sm90"), (40, "sm90"), (256, "sm90"),
                                    (4, "mma"), (12, "mma"), (250, "mma"), (260, "mma")])
def test_head_width_edges(d, want):
    assert kernel.variant(*_qkv(d=d)) == want


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2), (9, 3), (18, 2), (16, 8)])
def test_group_size_never_changes_the_kernel(hq, hkv):
    assert kernel.variant(*_qkv(hq=hq, hkv=hkv)) == "sm90"


@pytest.mark.parametrize("d", [8, 20, 256])
def test_float32_goes_to_the_simt_kernel(d):
    assert kernel.variant(*_qkv(d=d, dtype=torch.float32)) == "simt"


def test_misaligned_strides_go_to_the_mma_kernel():
    q, k, v = _qkv()
    wide = torch.zeros((1, 64, 2, 132), dtype=BF16)[..., :128]  # H stride 132: 264 bytes
    assert kernel.variant(q, wide, v) == "mma"
    rows = torch.zeros((1, 64, 4, 132), dtype=BF16)[:, :, :, 4:]  # base 8 bytes in
    assert rows.data_ptr() % 16 == 8 and kernel.variant(rows, k, v) == "mma"
    packed = torch.zeros((1, 64, 8, 128), dtype=BF16)  # views of one projection
    assert kernel.variant(packed[:, :, :4], packed[:, :, 4:6], packed[:, :, 6:]) == "sm90"
    shared = k[:, :, :1].expand(1, 64, 2, 128)  # an H stride of 0
    assert kernel.variant(q, shared, v) == "mma"


def test_size_one_dims_need_no_aligned_stride():
    q = torch.zeros((1, 1, 3, 64), dtype=BF16)
    odd = q.as_strided((1, 1, 3, 64), (5, 7, 64, 1))  # B and S strides never stepped over
    assert kernel._tma_strides(odd) == [192, 192, 64]
    assert kernel.variant(odd, odd, odd) == "sm90"
    assert kernel._tma_strides(torch.zeros((2, 9, 4, 64))) == [9 * 4 * 64, 4 * 64, 64]


def test_launching_a_kernel_of_another_dtype_raises():
    q, k, v = _qkv()
    with pytest.raises(ValueError, match="no kernel 'simt'"):
        kernel.launch_flash_attention(q, k, v, q.clone(), causal=True, window=None, cap=None,
                                      q_offset=0, variant="simt")
    f = [t.float() for t in (q, k, v)]
    for name in ("mma", "sm90", "tiled"):
        with pytest.raises(ValueError, match="no kernel"):
            kernel.launch_flash_attention(*f, f[0].clone(), causal=True, window=None, cap=None,
                                          q_offset=0, variant=name)


def test_launching_a_backward_kernel_of_another_dtype_raises():
    q, k, v = _qkv()
    f = [t.float() for t in (q, k, v)]
    lse = torch.zeros((q.shape[0], q.shape[2], q.shape[1]))
    for ts, name, forward in ((f, "bwd_mma", "simt"), ((q, k, v), "bwd_simt", "sm90"),
                              (f, "mma", "simt"), ((q, k, v), "bwd_mma", "simt"),
                              (f, "bwd_simt", "mma"), ((q, k, v), "bwd_sm90", "mma"),
                              (f, "bwd_sm90", "simt"), (f, "bwd_sm90", "sm90")):
        with pytest.raises(ValueError, match="no backward kernel"):
            kernel.launch_flash_attention_bwd(*ts, ts[0], lse, ts[0], lse.clone(),
                                              *(t.clone() for t in ts), causal=True,
                                              window=None, cap=None, q_offset=0, variant=name,
                                              forward=forward)


def test_backward_kernel_follows_the_forward_kernel():
    """``bwd_sm90`` exactly after the ``sm90`` forward, ``bwd_mma`` after the
    ``mma`` forward (D = 20; rows padded past D), ``bwd_simt`` for f32."""
    q, k, v = _qkv()
    assert kernel.variant(q, k, v) == "sm90" and kernel.bwd_variant(q, "sm90") == "bwd_sm90"
    narrow = _qkv(d=20)
    assert kernel.variant(*narrow) == "mma" and kernel.bwd_variant(narrow[0], "mma") == "bwd_mma"
    padded = [torch.zeros(t.shape[:3] + (132,), dtype=BF16)[..., :128] for t in (q, k, v)]
    assert kernel.variant(*padded) == "mma" and kernel.bwd_variant(padded[0], "mma") == "bwd_mma"
    f = [t.float() for t in (q, k, v)]
    assert kernel.variant(*f) == "simt" and kernel.bwd_variant(f[0], "simt") == "bwd_simt"


def test_bwd_sm90_refuses_a_cotangent_tma_refuses():
    """The launcher raises where TMA would refuse the cotangent (``ops``
    copies such a cotangent first)."""
    q, k, v = _qkv()
    lse = torch.zeros((q.shape[0], q.shape[2], q.shape[1]))
    buf = torch.zeros(q.numel() + 4, dtype=BF16)
    do = buf[4:].view(q.shape)
    assert do.is_contiguous() and not kernel.tma_ready(do) and kernel.tma_ready(q)
    with pytest.raises(ValueError, match="as TMA does"):
        kernel.launch_flash_attention_bwd(q, k, v, q, lse, do, lse.clone(), q.clone(), k.clone(),
                                          v.clone(), causal=True, window=None, cap=None,
                                          q_offset=0, variant="bwd_sm90", forward="sm90")


def test_every_kernel_has_its_own_counter():
    assert set(ops.COUNTERS) == set(kernel.VARIANTS) == {"sm90", "mma", "simt"}
    assert set(ops.BWD_COUNTERS) == set(kernel.BWD_VARIANTS) == {"bwd_sm90", "bwd_mma",
                                                                 "bwd_simt"}
    assert set(ops.launches) == {ops.FLASH_ATTENTION, *ops.COUNTERS.values(),
                                 ops.FLASH_ATTENTION_BWD, *ops.BWD_COUNTERS.values()}
    for name in ops.launches:
        ops.launches[name] = 3
    ops.reset_launches()
    assert set(ops.launches.values()) == {0}


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_cpu_calls_count_no_launch(dtype):
    q, k, v = (torch.randn(t.shape).to(dtype) for t in _qkv(sq=10, skv=12, d=16))
    ops.reset_launches()
    ops.flash_attention(q, k, v, causal=True, window=5, cap=30.0)
    assert set(ops.launches.values()) == {0}
