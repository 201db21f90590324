"""K6's launch plan (``mlagg_unet_torch.ops.mlla_attn_fused.local_launch_plan``)
and its plain twin against JAX's Pallas kernel at the wide stages.

The plan is pure Python over the map's shape, the type, the number of SMs,
the shared memory a block may use and the operands' dtype, device, layout
and alignment, so it is held here on CPU tensors: the kernel it picks from
the type, the tile, the k/v halo, the shared memory, the grid,
and what it refuses. The kernels run only on the card
(``test_torch_port_cuda.py``). The bf16 kernel rounds only k and v to bf16,
where the JAX kernel's scratch rounds them, so its twin is
``local_attention_fused_plain``, held here against JAX's Pallas kernel in
interpret mode at ch = 192 and 384 (``test_torch_port_fused.py`` does ch =
48 and 96 in fp32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_torch.ops.mlla_attn_fused import (
    SMEM_OPTIN,
    SMEM_PER_SM,
    LocalPlan,
    local_aggregated_attention_fused,
    local_attention_fused_plain,
    local_launch_plan,
)
from mlagg_unet_tpu.ops.mlla_attn_fused import local_aggregated_attention_fused as j_local
from port_helpers import one_torch_thread  # noqa: F401  (an autouse fixture)

BF16 = torch.bfloat16
SMS = 132              # an H100 SXM's SM count
MMA = "local_attn_mma_kernel"
STAGES = [(128, 112, 48, 1), (64, 56, 96, 2), (32, 28, 192, 4), (16, 14, 384, 8)]


@pytest.mark.parametrize("H,W,ch,nh,plan", [
    # 8 x 4 tiles of 16 x 28 per image, their halos 18 x 30
    (128, 112, 48, 1, LocalPlan(MMA, 16, 28, 540, 153_472, 512, 4)),
    (64, 56, 96, 2, LocalPlan(MMA, 16, 28, 540, 162_688, 256, 2)),
    # two tiles per image, their halos 18 x 28: one wave of 128 CTAs
    (32, 28, 192, 4, LocalPlan(MMA, 16, 28, 504, 183_424, 128, 1)),
    # the whole 16 x 14 map per CTA: no halo
    (16, 14, 384, 8, LocalPlan(MMA, 16, 14, 224, 184_960, 128, 1)),
])
def test_plan_at_the_flagship_stages(H, W, ch, nh, plan):
    """Model batch 16: the four stages' local halves."""
    assert local_launch_plan(16, H, W, ch, nh, BF16, SMS) == plan


@pytest.mark.parametrize("H,W,ch,nh", STAGES)
def test_plan_keeps_the_shared_memory_grid_and_halo_rules(H, W, ch, nh):
    p = local_launch_plan(16, H, W, ch, nh, BF16, SMS)
    # one CTA of 16 warps per SM: no room for a second
    assert p.smem_bytes + 1024 <= SMEM_PER_SM <= 2 * (p.smem_bytes + 1024)
    assert p.smem_bytes <= SMEM_OPTIN
    # k and v are projected for at most 1.3x the tile's tokens
    assert p.halo_tokens == min(p.tile_rows + 2, H) * min(p.tile_cols + 2, W)
    assert p.halo_tokens <= 1.3 * p.tile_rows * p.tile_cols
    tiles = -(-H // p.tile_rows) * -(-W // p.tile_cols)
    assert p.grid == tiles * nh * 16
    assert p.waves == -(-p.grid // SMS)
    assert p.grid >= 0.95 * SMS        # every stage fills (nearly) all the SMs


@pytest.mark.parametrize("B,H,W,ch,nh,plan", [
    # odd maps smaller than a tile: the whole map, its halo the map itself
    (2, 13, 11, 48, 1, LocalPlan(MMA, 13, 11, 143, 77_248, 2, 1)),
    (1, 1, 9, 96, 2, LocalPlan(MMA, 1, 9, 9, 60_736, 2, 1)),        # one row
    (2, 5, 1, 192, 4, LocalPlan(MMA, 5, 1, 5, 87_616, 8, 1)),       # one column
    (1, 1, 1, 48, 1, LocalPlan(MMA, 1, 1, 1, 49_984, 1, 1)),        # one token
    # ragged tiles: 2 x 2 tiles, the last of 1 row and 3 columns
    (3, 17, 31, 96, 2, LocalPlan(MMA, 16, 28, 510, 156_928, 24, 1)),
    # at ch = 384 a 16 x 28 tile's halo leaves too little shared memory: 16 x 14
    (2, 33, 57, 384, 8, LocalPlan(MMA, 16, 14, 288, 197_248, 240, 2)),
])
def test_plan_at_odd_one_row_and_one_column_maps(B, H, W, ch, nh, plan):
    assert local_launch_plan(B, H, W, ch, nh, BF16, SMS) == plan


@pytest.mark.parametrize("H,W,ch,nh,rows,smem,grid,waves", [
    (128, 112, 48, 1, 1, 185_920, 2048, 16),
    (64, 56, 96, 2, 4, 207_872, 512, 4),
    (32, 28, 192, 4, 6, 152_992, 384, 3),
    (16, 14, 384, 8, 5, 84_392, 512, 2),
])
def test_plan_picks_the_scalar_kernel_for_fp32(H, W, ch, nh, rows, smem, grid, waves):
    """fp32 keeps the scalar kernel and its rule: whole rows, the most whose
    fp32 q and k/v tiles fit the block's shared memory, cut so that the grid
    has 264 CTAs where the map allows."""
    p = local_launch_plan(16, H, W, ch, nh, torch.float32, SMS)
    assert p == LocalPlan("local_attn_kernel", rows, W, (rows + 2) * W, smem, grid, waves)


@pytest.mark.parametrize("optin,tile", [(SMEM_OPTIN, (16, 28)), (160_000, (16, 14)),
                                         (100_000, (8, 14)), (80_000, (4, 14))])
def test_plan_cuts_the_bf16_tile_to_the_devices_shared_memory(optin, tile):
    """Stage 1 (ch = 96): the largest tile of MMA_TILES that fits."""
    p = local_launch_plan(16, 64, 56, 96, 2, BF16, SMS, smem_optin=optin)
    assert (p.tile_rows, p.tile_cols) == tile and p.smem_bytes <= optin


def test_plan_fp32_rows_follow_the_devices_shared_memory():
    """A smaller opt-in limit gives fewer rows per CTA."""
    big = local_launch_plan(16, 64, 56, 96, 2, torch.float32, SMS)
    small = local_launch_plan(16, 64, 56, 96, 2, torch.float32, SMS, smem_optin=150_000)
    assert small.tile_rows < big.tile_rows and small.smem_bytes <= 150_000


def _operands(dtype=BF16, ch=96, nh=2, B=1, H=3, W=4):
    hd = ch // nh // 2
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    return [z(B, H, W, ch), z(ch, ch), z(ch), z(2 * ch, ch), z(2 * ch), z(2 * hd),
            z(ch, 1, 3, 3), z(ch), torch.tensor(0.3)]


def _shifted(shape, dtype=BF16):
    """A contiguous bf16 tensor starting 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 8, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[1:1 + n].view(shape)


def _bad(name):
    ops = _operands()
    if name == "mixed dtypes":
        ops[2] = ops[2].float()
    elif name == "mixed devices":
        ops[3] = torch.zeros(192, 96, dtype=BF16, device="meta")
    elif name == "non-contiguous weights":
        ops[1] = torch.zeros(96, 96, dtype=BF16).t()
    elif name == "a parameter of another shape":
        ops[5] = torch.zeros(24, dtype=BF16)
    elif name == "lam not fp32":
        ops[8] = torch.tensor(0.3, dtype=BF16)
    elif name == "unaligned ld":   # a channel slice of a map 100 wide: tokens 200 bytes apart
        ops[0] = torch.zeros(1, 3, 4, 100, dtype=BF16)[..., :96]
    elif name == "misaligned x":   # the slice from channel 4: 8 bytes past the boundary
        ops[0] = torch.zeros(1, 3, 4, 104, dtype=BF16)[..., 4:100]
    elif name == "misaligned wkv":
        ops[3] = _shifted((192, 96))
    elif name == "fp32 operands, bf16 plan":
        ops = _operands(dtype=torch.float32)
    else:
        raise KeyError(name)
    return ops


@pytest.mark.parametrize("name", ["mixed dtypes", "mixed devices", "non-contiguous weights",
                                  "a parameter of another shape", "lam not fp32",
                                  "unaligned ld", "misaligned x", "misaligned wkv",
                                  "fp32 operands, bf16 plan"])
def test_plan_raises_on_operands_the_kernel_does_not_take(name):
    with pytest.raises(ValueError):
        local_launch_plan(1, 3, 4, 96, 2, BF16, SMS, operands=_bad(name))


def test_plan_takes_an_aligned_channel_slice_and_unaligned_vectors():
    """The block's h1, the first half of a (B, H, W, 2 ch) map: tokens 2 ch
    apart. Only x and the two weights are read with 16-byte loads."""
    ops = _operands()
    ops[0] = torch.zeros(1, 3, 4, 192, dtype=BF16)[..., :96]
    ops[2] = _shifted((96,))
    assert local_launch_plan(1, 3, 4, 96, 2, BF16, SMS, operands=ops).kernel == MMA
    ops[0] = torch.zeros(1, 3, 4, 192, dtype=BF16)[..., 96:]   # the second half, 192 bytes in
    assert local_launch_plan(1, 3, 4, 96, 2, BF16, SMS, operands=ops).kernel == MMA


def test_plan_raises_on_a_grad_request():
    ops = _operands()
    ops[1].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        local_launch_plan(1, 3, 4, 96, 2, BF16, SMS, operands=ops)
    with torch.no_grad():  # no gradient asked: planned as usual
        assert local_launch_plan(1, 3, 4, 96, 2, BF16, SMS, operands=ops).kernel == MMA


@pytest.mark.parametrize("ch,nh", [(40, 1),    # head_dim 20
                                   (96, 1),    # head_dim 48
                                   (50, 1),    # not 2 nh head_dim
                                   (48, 0)])
def test_plan_raises_on_head_dims_the_kernels_do_not_take(ch, nh):
    for dtype in (BF16, torch.float32):
        with pytest.raises(ValueError):
            local_launch_plan(1, 4, 4, ch, nh, dtype, SMS)


def test_plan_raises_where_the_weights_do_not_fit_shared_memory():
    """ch = 768: a head's 144 weight rows are 221 KB of bf16."""
    with pytest.raises(ValueError, match="shared memory"):
        local_launch_plan(1, 16, 14, 768, 16, BF16, SMS)


def test_plan_raises_on_more_images_than_the_grid_takes():
    with pytest.raises(ValueError):
        local_launch_plan(65536, 4, 4, 48, 1, BF16, SMS)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_plan_rejects_other_dtypes(dtype):
    with pytest.raises(TypeError):
        local_launch_plan(1, 4, 4, 48, 1, dtype, SMS)


def _local_inputs(ch, nh, B, H, W, seed):
    rs = np.random.RandomState(seed)
    hd = ch // nh // 2
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(x=f(rs.randn(B, H, W, ch) * 0.5),
                wq=f(rs.randn(ch, ch) / np.sqrt(ch)),        # JAX (in, out)
                bq=f(0.1 * rs.randn(ch)),
                wkv=f(rs.randn(ch, 2 * ch) / np.sqrt(ch)),
                bkv=f(0.1 * rs.randn(2 * ch)),
                sub=f(1 + 0.2 * rs.randn(2 * hd)),
                lepe_k=f(rs.randn(3, 3, 1, ch) / 3),          # JAX (3, 3, 1, ch)
                lepe_b=f(0.1 * rs.randn(ch)),
                lam=np.float32(0.37))


@pytest.mark.parametrize("dtype,tol", [
    # fp32: only the order of fp32 sums differs
    (np.float32, 1e-5),
    # bf16: both round k and v (their scratch) and the output to bf16; fp32
    # sums in another order flip an occasional rounding, one bf16 ulp of an
    # element at most 2^-7 = 7.8e-3 of max|ref|
    ("bfloat16", 1e-2),
])
@pytest.mark.parametrize("ch,nh", [(192, 4), (384, 8)])
def test_local_attention_plain_matches_jax_kernel_at_wide_stages(ch, nh, dtype, tol):
    """The twin against JAX's Pallas kernel (interpret mode) on an odd 5 x 7
    map, at the two widest stages' widths and heads."""
    a = _local_inputs(ch, nh, 1, 5, 7, seed=ch)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = BF16 if dtype == "bfloat16" else torch.float32
    ref = j_local(*(jnp.asarray(a[k]).astype(jd) for k in
                    ("x", "wq", "bq", "wkv", "bkv", "sub", "lepe_k", "lepe_b")),
                  jnp.asarray(a["lam"]), nh)
    T = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(td)  # noqa: E731
    args = (T(a["x"]), T(a["wq"].T), T(a["bq"]), T(a["wkv"].T), T(a["bkv"]), T(a["sub"]),
            T(a["lepe_k"].transpose(3, 2, 0, 1)), T(a["lepe_b"]), torch.tensor(a["lam"]), nh)
    got = local_attention_fused_plain(*args)
    assert got.dtype == td
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), err
    # the wrapper takes the twin on a CPU tensor
    assert torch.equal(local_aggregated_attention_fused(*args), got)
