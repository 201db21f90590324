"""K4's launch plan (``mlagg_unet_torch.ops.flash_attention.launch_plan``).

The plan is pure Python over shapes, strides, q's address and the number of
SMs, so it is held here on CPU tensors: the kernel it picks from the type,
the copy widths from alignment and strides, the padded head dims, the 1-D
grid, and what it refuses. The kernels themselves run only on the card
(``test_torch_port_cuda.py``).
"""
import pytest
import torch

from mlagg_unet_torch.ops.flash_attention import LaunchPlan, launch_plan

BF16 = torch.bfloat16
SMS = 132  # an H100 SXM's SM count


def _pooled(N, nh, group, dtype=BF16, B=16, hd=24, P=56):
    """The pooled branch's views: q, k of (B, L, nh, 2, hd), v of (B, P, nh, 2 hd)."""
    q = torch.zeros(B, N, nh, 2, hd, dtype=dtype)[:, :, :, group].transpose(1, 2)
    k = torch.zeros(B, P, nh, 2, hd, dtype=dtype)[:, :, :, group].transpose(1, 2)
    v = torch.zeros(B, P, nh, 2 * hd, dtype=dtype).transpose(1, 2)
    return q, k, v


def _dense(b, h, lq, lk, dk, dv, dtype=BF16):
    return (torch.zeros(b, h, lq, dk, dtype=dtype), torch.zeros(b, h, lk, dk, dtype=dtype),
            torch.zeros(b, h, lk, dv, dtype=dtype))


def _shifted(shape, offset, dtype=BF16):
    """A contiguous tensor whose start is ``offset`` elements into its storage."""
    n = 1
    for d in shape:
        n *= d
    base = torch.zeros(n + 16, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[offset:offset + n].view(shape)


@pytest.mark.parametrize("dtype,kernel", [(BF16, "flash_fwd_mma_kernel"),
                                          (torch.float32, "flash_fwd_fp32_kernel")])
def test_plan_picks_the_kernel_by_dtype(dtype, kernel):
    assert launch_plan(*_pooled(224, 8, 0, dtype), SMS).kernel == kernel


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_plan_rejects_other_dtypes(dtype):
    with pytest.raises(TypeError):
        launch_plan(*_dense(1, 1, 8, 8, 8, 8, dtype), SMS)


@pytest.mark.parametrize("group", [0, 1])
@pytest.mark.parametrize("N,nh", [(14336, 1), (3584, 2), (896, 4), (224, 8)])
def test_plan_copies_the_pooled_views_16_bytes_at_a_time(N, nh, group):
    """Rows of 48 bytes, 96 nh bytes apart; group 1 starts 48 bytes in."""
    q, k, v = _pooled(N, nh, group)
    plan = launch_plan(q, k, v, SMS)
    assert (plan.copy_bytes, plan.kv_copy_bytes) == (16, 16)


def _q_case(name):
    k = torch.zeros(2, 3, 20, 8, dtype=BF16)
    v = torch.zeros(2, 3, 20, 16, dtype=BF16)
    if name == "offset 2 elements":
        return _shifted((2, 3, 40, 8), 2), k, v
    if name == "offset 1 element":
        return _shifted((2, 3, 40, 8), 1), k, v
    if name == "row stride 12":
        return torch.zeros(2, 3, 40, 12, dtype=BF16)[..., :8], k, v
    if name == "dk 6":
        return (torch.zeros(2, 3, 40, 6, dtype=BF16), torch.zeros(2, 3, 20, 6, dtype=BF16), v)
    if name == "dk 5":
        return (torch.zeros(2, 3, 40, 5, dtype=BF16), torch.zeros(2, 3, 20, 5, dtype=BF16), v)
    if name == "odd stride of a size-1 dim":
        q = torch.zeros(1, 3, 40, 8, dtype=BF16).as_strided((1, 3, 40, 8), (7, 320, 8, 1))
        return q, k[:1], v[:1]
    raise KeyError(name)


@pytest.mark.parametrize("name,width", [
    ("offset 2 elements", 4),            # 4-byte aligned start
    ("offset 1 element", 2),             # 2-byte start: plain loads
    ("row stride 12", 4),                # 24-byte rows apart
    ("dk 6", 4),                         # 12-byte rows
    ("dk 5", 2),                         # 10-byte rows
    ("odd stride of a size-1 dim", 16),  # never stepped along
])
def test_plan_picks_q_copy_width_from_alignment_and_strides(name, width):
    assert launch_plan(*_q_case(name), SMS).copy_bytes == width


@pytest.mark.parametrize("v_offset,width", [(0, 16), (2, 4), (1, 2)])
def test_plan_copies_k_and_v_at_their_narrower_width(v_offset, width):
    q, k, _ = _dense(2, 3, 40, 20, 8, 16)
    v = _shifted((2, 3, 20, 16), v_offset)
    plan = launch_plan(q, k, v, SMS)
    assert (plan.copy_bytes, plan.kv_copy_bytes) == (16, width)


@pytest.mark.parametrize("dk,dv,dkp,dvp", [(24, 48, 32, 48), (8, 16, 16, 16), (128, 128, 128, 128),
                                           (1, 1, 16, 8), (33, 20, 48, 24), (100, 127, 112, 128)])
def test_plan_pads_head_dims_for_the_mma_tiles(dk, dv, dkp, dvp):
    plan = launch_plan(*_dense(1, 2, 70, 9, dk, dv), SMS)
    assert (plan.dk_pad, plan.dv_pad) == (dkp, dvp)
    fp32 = launch_plan(*_dense(1, 2, 70, 9, dk, dv, torch.float32), SMS)
    assert (fp32.dk_pad, fp32.dv_pad) == (dk, dv)


@pytest.mark.parametrize("N,nh,per_cta,grid", [(14336, 1, 6, 608), (3584, 2, 3, 608),
                                               (896, 4, 2, 448), (224, 8, 1, 512)])
def test_plan_grid_at_the_flagship_stages(N, nh, per_cta, grid):
    """Model batch 16: about 5 CTAs per SM, each walking a run of query tiles."""
    plan = launch_plan(*_pooled(N, nh, 1), SMS)
    assert (plan.tiles_per_cta, plan.grid) == (per_cta, grid)
    tiles = -(-N // 64)
    assert plan.grid == 16 * nh * -(-tiles // per_cta)


@pytest.mark.parametrize("b,h,lq,dk,dv,sms,plan", [
    # b * h = 70,000: one CTA per head on the 1-D grid, past gridDim.y's 65535
    (2, 35000, 10, 8, 16, SMS, LaunchPlan("flash_fwd_mma_kernel", 16, 16, 16, 16, 1, 70000)),
    # the wide instantiation aims at 2 CTAs per SM: 2 x 3 x 16 tiles on 4 SMs x 2
    (2, 3, 1000, 128, 128, 4, LaunchPlan("flash_fwd_mma_kernel", 128, 128, 16, 16, 12, 12)),
    # fp32: one CTA per 64 queries of each head
    (2, 3, 1000, 24, 48, SMS, LaunchPlan("flash_fwd_fp32_kernel", 24, 48, 0, 0, 1, 96)),
    # no query rows: nothing to launch
    (2, 3, 0, 24, 48, SMS, LaunchPlan("flash_fwd_mma_kernel", 32, 48, 16, 16, 1, 0)),
])
def test_plan_grid_at_edge_shapes(b, h, lq, dk, dv, sms, plan):
    dtype = torch.float32 if plan.kernel == "flash_fwd_fp32_kernel" else BF16
    assert launch_plan(*_dense(b, h, lq, 12, dk, dv, dtype), sms) == plan


def _bad(name):
    q, k, v = _dense(2, 3, 40, 20, 8, 16)
    if name == "k head dim":
        return q, torch.zeros(2, 3, 20, 9, dtype=BF16), v
    if name == "v batch":
        return q, k, torch.zeros(1, 3, 20, 16, dtype=BF16)
    if name == "k dtype":
        return q, k.float(), v
    if name == "v device":
        return q, k, torch.zeros(2, 3, 20, 16, dtype=BF16, device="meta")
    if name == "q last stride":
        return torch.zeros(2, 3, 8, 40, dtype=BF16).transpose(-1, -2), k, v
    if name == "dk 129":
        return (torch.zeros(2, 3, 40, 129, dtype=BF16), torch.zeros(2, 3, 20, 129, dtype=BF16), v)
    if name == "dv 0":
        return q, k, torch.zeros(2, 3, 20, 0, dtype=BF16)
    if name == "lk 0":
        return q, torch.zeros(2, 3, 0, 8, dtype=BF16), torch.zeros(2, 3, 0, 16, dtype=BF16)
    if name == "grid past 2^31 - 1":
        qe, ke, ve = (torch.zeros(1, 1, n, d).expand(2 ** 16, 2 ** 15 + 1, n, d)
                      for n, d in ((40, 8), (20, 8), (20, 16)))
        return qe, ke, ve
    raise KeyError(name)


@pytest.mark.parametrize("name", ["k head dim", "v batch", "k dtype", "v device", "q last stride",
                                  "dk 129", "dv 0", "lk 0", "grid past 2^31 - 1"])
def test_plan_raises_on_what_the_kernels_do_not_take(name):
    with pytest.raises(ValueError):
        launch_plan(*_bad(name), SMS)
