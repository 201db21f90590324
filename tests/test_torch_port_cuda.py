"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda`` and skipped without a card. The file imports no JAX, so it
also runs on a machine that has none:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py``
(``tests/conftest.py`` imports JAX). Tolerance: fp32 I/O, max|diff| <=
1e-4 * max|ref| (only the order of fp32 sums differs); the scan's gradients
2e-4 * max|ref| each (``PARITY.md:70``: the adjoint sums over L in another
order), 2e-2 with bf16 operands; the attention (K4), the fused local
attention and instance norm 2e-2 with bf16 I/O (one bf16 rounding of the
output and of the twin's intermediates; K4 rounds the unnormalised
probabilities where the twin rounds the normalised ones). K6's bf16
tensor-core kernel rounds only where its twin rounds (k, v and the output):
1e-2, one bf16 ulp of the output's largest element (<= 2^-7 of it) flipped
by fp32 sums in another order. K2's and K3's
bf16 tensor-core kernels: 2e-2 against the bf16 twins (which round LN's
output, K3's x2 and every product's output), 4e-3 against
``mlla_front_bf16_operands_plain`` and ``mlla_tail_bf16_operands_plain``,
which round where the kernels do: half a bf16 ulp of the output (<= 2^-9 of
a value) plus the odd operand rounded the other way after sums in another
order.
"""
import numpy as np
import pytest
import torch

from mlagg_unet_torch.ops.flash_attention import attention_reference, flash_attention
from mlagg_unet_torch.ops.fused_norm import fused_instance_norm, instance_norm_plain
from mlagg_unet_torch.ops.mlla_attn_fused import (
    local_aggregated_attention_fused,
    local_attention_fused_plain,
)
from mlagg_unet_torch.ops.mlla_fused import (
    mlla_front,
    mlla_front_bf16_operands_plain,
    mlla_front_plain,
    mlla_tail,
    mlla_tail_bf16_operands_plain,
    mlla_tail_plain,
)
from mlagg_unet_torch.ops.selective_scan import (
    selective_scan,
    selective_scan_bwd_plain,
    selective_scan_bwd_tiled_plain,
    selective_scan_fwd_tiled_plain,
    selective_scan_seq_ref,
    selective_scan_states,
)
from mlagg_unet_torch.ops.selective_scan_cuda import (
    FWD,
    scan_bwd_launch_plan,
    scan_fwd_launch_plan,
    selective_scan_bwd,
    selective_scan_fwd,
    selective_scan_fwd_states,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dev, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dev, dtype)


def _close(got, ref, rel=1e-4):
    torch.cuda.synchronize()
    err = (got.float().cpu() - ref.float().cpu()).abs().max().item()
    assert err <= rel * ref.float().abs().max().item(), err


def _scan_args(dev, dtype, b=3, g=2, d=40, n=16, l=1000, optionals=True):
    """d and l not multiples of a warp's 32 channels and of 64-step tiles."""
    u = _rand((b, g, d, l), dev, dtype, 0)
    dl = _rand((b, g, d, l), dev, dtype, 1, 0.5)
    B, C = _rand((b, g, n, l), dev, dtype, 2), _rand((b, g, n, l), dev, dtype, 3)
    A = -torch.exp(_rand((g, d, n), dev, torch.float32, 4, 0.3))
    D = _rand((g, d), dev, torch.float32, 5) if optionals else None
    db = _rand((g, d), dev, torch.float32, 6, 0.1) if optionals else None
    return [u, dl, A, B, C, D, db]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_kernel_matches_plain(cuda_device, dtype, reverse):
    b, g, d, n, l = 3, 2, 40, 16, 1000  # d and l not multiples of the tiles
    u = _rand((b, g, d, l), cuda_device, dtype, 0)
    dl = _rand((b, g, d, l), cuda_device, dtype, 1, 0.5)
    B, C = _rand((b, g, n, l), cuda_device, dtype, 2), _rand((b, g, n, l), cuda_device, dtype, 3)
    A = -torch.exp(_rand((g, d, n), cuda_device, torch.float32, 4, 0.3))
    D = _rand((g, d), cuda_device, torch.float32, 5)
    db = _rand((g, d), cuda_device, torch.float32, 6, 0.1)
    y = selective_scan_fwd(u, dl, A, B, C, D, db, True, reverse)
    assert y.dtype == torch.float32
    _close(y, selective_scan(u, dl, A, B, C, D, db, True, reverse=reverse))


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_states_match_plain(cuda_device, reverse):
    """K1 with states: y bit-equal to K1 without them, the states equal to
    the plain scan's h at the tile entries."""
    args = _scan_args(cuda_device, torch.float32)
    y, states = selective_scan_fwd_states(*args, True, reverse)
    assert torch.equal(y, selective_scan_fwd(*args, True, reverse))
    u, dl, A, B, C, _, db = args
    _close(states, selective_scan_states(u, dl, A, B, C, db, True, 64, reverse))


def _fwd_plan(args):
    props = torch.cuda.get_device_properties(args[0].device)
    return scan_fwd_launch_plan(*args[0].shape, args[0].dtype, props.multi_processor_count,
                                props.shared_memory_per_block_optin, args)


def _scan_fwd_against_twins(args, reverse, step=None):
    """K1 against the chunked scan and the tiled twin (which splits the work
    as K1 does, over groups of the plan's tiles per CTA; by slices of
    ``step`` batch entries where given), two runs bit-equal, y with states
    bit-equal to y without and the states equal to the plain scan's. Returns
    the plan and the states."""
    plan = _fwd_plan(args)
    y = selective_scan_fwd(*args, True, reverse)
    again = selective_scan_fwd(*args, True, reverse)
    y_s, states = selective_scan_fwd_states(*args, True, reverse)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and y.shape == args[0].shape
    assert torch.equal(y, again) and torch.equal(y, y_s)
    b, step = args[0].shape[0], step or args[0].shape[0]
    tiled = torch.cat([selective_scan_fwd_tiled_plain(
        *(t[i:i + step] if t is not None and t.dim() == 4 else t for t in args), True, reverse,
        64 * plan.tiles_per_cta) for i in range(0, b, step)])
    _close(y, selective_scan(*args, True, reverse=reverse))
    _close(y, tiled)
    u, dl, A, B, C, _, db = args
    _close(states, selective_scan_states(u, dl, A, B, C, db, True, 64, reverse))
    return plan, states


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("l", [1, 63, 65, 1000])
def test_scan_fwd_kernel_at_ragged_lengths(cuda_device, dtype, reverse, l):
    """d = 20 (one CTA of 32 threads, 12 without a channel), L under one
    tile, ragged (element-by-element accesses), and a multiple of 8 (16-byte
    accesses) with a ragged last tile."""
    args = _scan_args(cuda_device, dtype, b=2, d=20, l=l)
    plan, _ = _scan_fwd_against_twins(args, reverse)
    assert plan.vec == int(l % 8 == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rows_per_sm, l, k", [(30, 1024, 8), (30, 1000, 8), (12, 1280, 4)])
def test_scan_fwd_kernel_with_large_tile_groups(cuda_device, dtype, reverse, rows_per_sm, l, k):
    """Enough rows that the plan gives each CTA a group of k > 1 tiles (16
    tiles: 2 groups of 8; 20 tiles: 5 groups of 4, as 4 groups of 5 would
    leave too few CTAs), so the carry across groups, the states written
    inside a group and the B / C copies issued for a group's next tile all
    run; L = 1000 makes one tile ragged. Against both twins, two runs
    bit-equal, y with states bit-equal to y without."""
    props = torch.cuda.get_device_properties(cuda_device)
    b = rows_per_sm * props.multi_processor_count // 2
    args = _scan_args(cuda_device, dtype, b=b, d=40, l=l)
    plan, _ = _scan_fwd_against_twins(args, reverse, step=64)
    assert (plan.tiles_per_cta, plan.groups, plan.vec) == (k, -(-l // 64 // k), 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_fwd_kernel_takes_unaligned_operands(cuda_device, dtype):
    """u starting 4 bytes past a 16-byte boundary: the plan goes element by
    element (vec 0), and y and the states are bit-equal to those of an
    aligned copy (only the accesses differ, not the arithmetic)."""
    args = _scan_args(cuda_device, dtype, b=2, d=24, l=1024)
    base = torch.empty(args[0].numel() + 8, device=cuda_device, dtype=dtype)
    shifted = base[4 // args[0].element_size():][:args[0].numel()].view_as(args[0])
    shifted.copy_(args[0])
    assert _fwd_plan([shifted, *args[1:]]).vec == 0 and _fwd_plan(args).vec == 1
    for rev in (False, True):
        got = selective_scan_fwd_states(shifted, *args[1:], True, rev)
        ref = selective_scan_fwd_states(*args, True, rev)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_bwd_from_states_written_inside_k1_groups(cuda_device, dtype, reverse):
    """K5 on the tile-entry states that K1 writes inside its groups of 4
    tiles (1,584 rows on 132 SMs), against the plain backward."""
    props = torch.cuda.get_device_properties(cuda_device)
    b = 12 * props.multi_processor_count // 2
    args = _scan_args(cuda_device, dtype, b=b, d=40, l=1280)
    assert _fwd_plan(args).tiles_per_cta == 4
    gy = _rand(args[0].shape, cuda_device, torch.float32, 12)
    _, states = selective_scan_fwd_states(*args, True, reverse)
    got = selective_scan_bwd(*args, True, reverse, gy, states)
    ref = selective_scan_bwd_plain(*args, True, reverse, gy)
    for name, g_, r_ in zip(SCAN_GRADS, got, ref):
        assert g_.dtype == r_.dtype, name
        _close(g_, r_, 2e-4 if dtype == torch.float32 else 2e-2)


def test_scan_fwd_kernel_launches_nothing_for_an_empty_batch(cuda_device):
    args = _scan_args(cuda_device, torch.bfloat16, b=0, d=20, l=100)
    before = FWD.launches
    y = selective_scan_fwd(*args, True, False)
    y_s, states = selective_scan_fwd_states(*args, True, True)
    assert FWD.launches == before
    assert y.shape == y_s.shape == (0, 2, 20, 100) and states.shape == (0, 2, 2, 20, 16)


def _bad_fwd(dev, name):
    args = _scan_args(dev, torch.bfloat16, b=1, d=8, l=128)
    if name == "fp16":
        args = [t.half() if t.dim() == 4 else t for t in args]
    elif name == "8 states":
        args[2] = args[2][..., :8].contiguous()
        args[3], args[4] = args[3][:, :, :8].contiguous(), args[4][:, :, :8].contiguous()
    elif name == "mixed dtypes":
        args[1] = args[1].float()
    elif name == "non-contiguous u":
        args[0] = args[0].transpose(2, 3).contiguous().transpose(2, 3)
    elif name == "B's shape":
        args[3] = args[3][..., :127].contiguous()
    elif name == "C on the CPU":
        args[4] = args[4].cpu()
    elif name == "D's shape":
        args[5] = args[5][:, :7].contiguous()
    elif name == "L = 0":
        args = _scan_args(dev, torch.bfloat16, b=1, d=8, l=0)
    else:
        raise KeyError(name)
    return args


@pytest.mark.parametrize("name", ["fp16", "8 states", "mixed dtypes", "non-contiguous u",
                                  "B's shape", "C on the CPU", "D's shape", "L = 0"])
def test_scan_fwd_raises_on_what_k1_does_not_take(cuda_device, name):
    args = _bad_fwd(cuda_device, name)
    for fn in (selective_scan_fwd, selective_scan_fwd_states):
        with pytest.raises(TypeError if name == "fp16" else ValueError):
            fn(*args, True, False)


SCAN_GRADS = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")


def _scan_bwd_against_twins(args, reverse, gy, states, rel, tiled=None):
    """K5 against selective_scan_bwd_plain and the tiled twin (which splits
    the work as K5 does, over K1's 64-step tiles; ``tiled``: its gradients
    computed by the caller), and two runs bit-equal: no atomics, dB and dC
    summed over the channels in a fixed order."""
    got = selective_scan_bwd(*args, True, reverse, gy, states)
    again = selective_scan_bwd(*args, True, reverse, gy, states)
    ref = selective_scan_bwd_plain(*args, True, reverse, gy)
    if tiled is None:
        tiled = selective_scan_bwd_tiled_plain(*args, True, reverse, gy)
    torch.cuda.synchronize()
    for name, g_, a_, r_, t_ in zip(SCAN_GRADS, got, again, ref, tiled):
        if r_ is None:
            assert g_ is None and t_ is None, name
            continue
        assert g_.dtype == r_.dtype and g_.shape == r_.shape, name
        assert torch.equal(g_, a_), name
        _close(g_, r_, rel)
        _close(g_, t_, rel)


@pytest.mark.parametrize("optionals", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_bwd_kernel_matches_plain(cuda_device, dtype, reverse, optionals):
    args = _scan_args(cuda_device, dtype, optionals=optionals)
    gy = _rand(args[0].shape, cuda_device, torch.float32, 7)
    _, states = selective_scan_fwd_states(*args, True, reverse)
    _scan_bwd_against_twins(args, reverse, gy, states, 2e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("l", [1, 63, 65, 1000])
def test_scan_bwd_kernel_at_ragged_lengths(cuda_device, dtype, reverse, l):
    """d = 20 (one chunk of 32 channels with 12 empty), L under one tile,
    ragged, and a multiple of 8 (16-byte staging) with a ragged tile."""
    args = _scan_args(cuda_device, dtype, b=2, d=20, l=l)
    gy = _rand(args[0].shape, cuda_device, torch.float32, 8)
    _, states = selective_scan_fwd_states(*args, True, reverse)
    _scan_bwd_against_twins(args, reverse, gy, states, 2e-4 if dtype == torch.float32 else 2e-2)


def _tiled_twin_by_rows(args, reverse, gy, step):
    """selective_scan_bwd_tiled_plain over slices of ``step`` batch entries
    (its (b, g, d, L, n) fp32 temporaries of a whole large batch take tens
    of GB): du, ddelta, dB, dC joined, dA, dD, dbias summed."""
    parts = []
    for i in range(0, args[0].shape[0], step):
        sl = [t[i:i + step] if t is not None and t.dim() == 4 else t for t in args]
        parts.append(selective_scan_bwd_tiled_plain(*sl, True, reverse, gy[i:i + step]))
    return tuple(None if ps[0] is None
                 else torch.cat(ps) if k in (0, 1, 3, 4) else torch.stack(ps).sum(0)
                 for k, ps in enumerate(zip(*parts)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("rows_per_sm, l, k", [(10, 1024, 8), (10, 1000, 8), (4, 1280, 4)])
def test_scan_bwd_kernel_with_large_tile_groups(cuda_device, dtype, reverse, rows_per_sm, l, k):
    """Enough rows that the plan gives each CTA a group of k > 1 tiles (16
    tiles: 2 groups of 8; 20 tiles: 5 groups of 4, as 4 groups of 5 would
    leave too few CTAs), so the running carry kept in the carry buffer, the
    dA / dD / dbias partials added across a group's tiles and the delta
    copied ahead across tiles all run; L = 1000 makes one tile ragged.
    Against both twins, two runs bit-equal."""
    props = torch.cuda.get_device_properties(cuda_device)
    b = rows_per_sm * props.multi_processor_count // 2
    args = _scan_args(cuda_device, dtype, b=b, d=40, l=l)
    gy = _rand(args[0].shape, cuda_device, torch.float32, 11)
    _, states = selective_scan_fwd_states(*args, True, reverse)
    ops = (*args, gy, states)
    plan = scan_bwd_launch_plan(b, 2, 40, l, dtype, props.multi_processor_count,
                                props.shared_memory_per_block_optin, ops)
    assert plan.tiles_per_cta == k and plan.groups == -(-l // 64 // k) and plan.vec == 1
    _scan_bwd_against_twins(args, reverse, gy, states, 2e-4 if dtype == torch.float32 else 2e-2,
                            _tiled_twin_by_rows(args, reverse, gy, 64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_bwd_kernel_takes_unaligned_operands(cuda_device, dtype):
    """u starting 4 bytes past a 16-byte boundary: the plan stages element
    by element (vec 0), and the gradients are bit-equal to those of an
    aligned copy (only the staging differs, not the arithmetic)."""
    args = _scan_args(cuda_device, dtype, b=2, d=24, l=1024)
    base = torch.empty(args[0].numel() + 8, device=cuda_device, dtype=dtype)
    shifted = base[4 // args[0].element_size():][:args[0].numel()].view_as(args[0])
    shifted.copy_(args[0])
    props = torch.cuda.get_device_properties(cuda_device)
    gy = _rand(args[0].shape, cuda_device, torch.float32, 9)
    _, states = selective_scan_fwd_states(*args, True, False)
    ops = (shifted, *args[1:], gy, states)
    plan = scan_bwd_launch_plan(2, 2, 24, 1024, dtype, props.multi_processor_count,
                                props.shared_memory_per_block_optin, ops)
    assert plan.vec == 0
    got = selective_scan_bwd(shifted, *args[1:], True, False, gy, states)
    ref = selective_scan_bwd(*args, True, False, gy, states)
    torch.cuda.synchronize()
    for name, g_, r_ in zip(SCAN_GRADS, got, ref):
        assert torch.equal(g_, r_), name


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_bwd_fp32_matches_autograd_of_step_scan(cuda_device, reverse):
    """The fp32 kernels against autograd through the step-by-step scan (the
    ground truth), at L = 1000 (a ragged tile) and d = 40 (two chunks)."""
    args = _scan_args(cuda_device, torch.float32, b=2)
    gy = _rand(args[0].shape, cuda_device, torch.float32, 10)
    leaves = [t.clone().requires_grad_() for t in args]
    y = selective_scan_seq_ref(*leaves, delta_softplus=True, reverse=reverse)
    ref = torch.autograd.grad(y, leaves, gy)
    _, states = selective_scan_fwd_states(*args, True, reverse)
    got = selective_scan_bwd(*args, True, reverse, gy, states)
    for name, g_, r_ in zip(SCAN_GRADS, got, ref):
        _close(g_, r_, 2e-4)


def test_scan_autograd_on_card_matches_plain(cuda_device):
    """Gradients through selective_scan_fwd on the card (K1 + K5) equal the
    plain path's on the CPU: no gradient is lost."""
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        args = [t.to(dev).requires_grad_()
                for t in _scan_args(cuda_device, torch.float32, l=300)]
        y = selective_scan_fwd(*args, True, True)
        (y * torch.linspace(-1, 1, y.shape[-1], device=dev)).sum().backward()
        grads.append([t.grad for t in args])
    for g_, r_ in zip(*grads):
        assert g_ is not None
        _close(g_, r_, 2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_autograd_on_card_matches_plain(cuda_device, dtype):
    """K4's backward recomputes the plain attention: dq, dk, dv equal the
    CPU's, on the strided head views the pooled branch hands it (bf16: the
    forward is the mma kernel, the CPU's the twin)."""
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        qg = _rand((2, 300, 4, 2, 24), dev, dtype, 0, 0.2).requires_grad_()
        kg = _rand((2, 56, 4, 2, 24), dev, dtype, 1).requires_grad_()
        v = _rand((2, 56, 4, 48), dev, dtype, 2).requires_grad_()
        out = flash_attention(qg[:, :, :, 1].transpose(1, 2),
                              kg[:, :, :, 1].transpose(1, 2), v.transpose(1, 2), 0.2)
        (out.float() ** 2).sum().backward()
        grads.append([qg.grad, kg.grad, v.grad])
    for g_, r_ in zip(*grads):
        _close(g_, r_, _attn_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlla_kernels_raise_under_grad(cuda_device, dtype):
    """bf16: the front's and the tail's tensor-core kernels raise too (C = 32,
    their narrowest)."""
    C = 32
    x = torch.zeros(4, C, device=cuda_device, dtype=dtype)
    w = torch.zeros(C, C, device=cuda_device, dtype=dtype, requires_grad=True)
    b = torch.zeros(C, device=cuda_device, dtype=dtype)
    w1 = torch.zeros(2 * C, C, device=cuda_device, dtype=dtype)
    b1 = torch.zeros(2 * C, device=cuda_device, dtype=dtype)
    w2 = torch.zeros(C, 2 * C, device=cuda_device, dtype=dtype)
    with pytest.raises(RuntimeError, match="no backward"):
        mlla_front(x, b, b, w, b, w, b)
    with pytest.raises(RuntimeError, match="no backward"):
        mlla_tail(x, x, x, w, b, b, b, w1, b1, w2, b)
    with torch.no_grad():  # no gradient asked: the kernels run
        mlla_front(x, b, b, w, b, w, b)
        mlla_tail(x, x, x, w, b, b, b, w1, b1, w2, b)


def test_train_step_on_card_matches_cpu(cuda_device):
    """A small flagship, fp32, drop path off: the loss and every parameter
    gradient of one training batch on the card equal the CPU's."""
    from mlagg_unet_torch import Trainer

    tiny = dict(embed_dim=32, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
                sr_ratio=(8, 4, 2, 2), drop_path_rate=0.0, skip_drop_path=0.0)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 96, 1).astype(np.float32))
    y = (x[..., 0] > 0.3).long() + (x[..., 0] > 1.0).long()
    result = []
    for dev in (cuda_device, "cpu"):
        tr = Trainer(patch_size=(64, 96), batch_size=2, num_classes=3, seed=1,
                     device=dev, compute_dtype=torch.float32, network_overrides=tiny)
        loss = tr.forward_loss(x.to(tr.device), y.to(tr.device))
        loss.backward()
        result.append((loss.item(), {k: p.grad.cpu() for k, p in tr.network.named_parameters()}))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = result
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for k, r_ in g_cpu.items():
        err = (g_gpu[k] - r_).abs().max().item()
        assert err <= 1e-3 * r_.abs().max().item() + 1e-6, k


@pytest.mark.parametrize("dtype,C,tokens", [
    (torch.float32, 96, 1000), (torch.float32, 192, 257), (torch.float32, 768, 33),
    (torch.bfloat16, 96, 1000), (torch.bfloat16, 192, 257), (torch.bfloat16, 384, 33),
    (torch.bfloat16, 768, 3584 + 5),
    (torch.bfloat16, 32, 77), (torch.bfloat16, 736, 40)])  # narrower than their instantiations
def test_mlla_kernels_match_plain(cuda_device, dtype, C, tokens):
    """Every stage width, token counts that are not a multiple of the CTA's
    token tile. bf16: K3's tensor-core kernel against both twins, two runs
    bit-equal."""
    def w(n_out, n_in, seed):  # (out, in), variance 1 / n_in
        return _rand((n_out, n_in), cuda_device, dtype, seed, n_in ** -0.5)

    def b(n, seed):
        return _rand((n,), cuda_device, dtype, seed, 0.1)

    x, h, a = (_rand((tokens, C), cuda_device, dtype, i) for i in range(3))
    lw, lb = 1 + b(C, 10), b(C, 11)
    fa = (x, lw, lb, w(C, C, 20), b(C, 12), w(C, C, 21), b(C, 13))
    ta = (h, a, x, w(C, C, 22), b(C, 14), lw, lb, w(2 * C, C, 23), b(2 * C, 15),
          w(C, 2 * C, 24), b(C, 16))
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for got, ref in zip(mlla_front(*fa), mlla_front_plain(*fa)):
        _close(got, ref, rel)
    got = mlla_tail(*ta)
    assert got.dtype == dtype and got.shape == (tokens, C)
    _close(got, mlla_tail_plain(*ta), rel)
    if dtype == torch.bfloat16:
        _close(got, mlla_tail_bf16_operands_plain(*ta), 4e-3)
        assert torch.equal(got, mlla_tail(*ta))


@pytest.mark.parametrize("C,tokens", [
    (32, 77), (64, 1), (96, 1000),
    (96, 64 * 264 + 5),   # more tiles than CTAs: each walks two or three
    (128, 300),           # 2 C = 256: passes of 192 and 64 columns
    (160, 129), (192, 257),
    (192, 57344),         # the flagship's stage 1 at model batch 16
    (224, 500),           # 2 C = 448: a last column chunk of 64 rows
    (384, 33), (384, 14336 + 7), (416, 100), (736, 40), (768, 3589)])
def test_front_mma_kernel_matches_both_twins(cuda_device, C, tokens):
    """K2 in bf16 (``front_mma_kernel``) at C = 32-768 with ragged token
    counts: within 2e-2 of the bf16 twin, 4e-3 of the twin that rounds where
    the kernel rounds, and two runs bit-equal."""
    def w(seed):  # (out, in), variance 1 / C
        return _rand((C, C), cuda_device, torch.bfloat16, seed, C ** -0.5)

    def b(seed):
        return _rand((C,), cuda_device, torch.bfloat16, seed, 0.1)

    x = _rand((tokens, C), cuda_device, torch.bfloat16, 0, 2.0) + 0.5
    fa = (x, 1 + b(10), b(11), w(20), b(12), w(21), b(13))
    got = mlla_front(*fa)
    for g, r, r_ops in zip(got, mlla_front_plain(*fa), mlla_front_bf16_operands_plain(*fa)):
        assert g.dtype == torch.bfloat16 and g.shape == (tokens, C)
        _close(g, r, 2e-2)
        _close(g, r_ops, 4e-3)
    for g, again in zip(got, mlla_front(*fa)):
        assert torch.equal(g, again)


def _attn_tol(dtype):
    return 1e-4 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,dk,dv", [
    (1000, 56, 24, 48),   # lq not a multiple of the 64-row tile
    (33, 56, 24, 48),     # less than one tile
    (130, 200, 32, 32),   # four key blocks, the last of 8 keys
    (1000, 130, 24, 48),  # three key blocks, the last of 2 keys
    (256, 64, 128, 128),  # the widest head dims
    (100, 20, 8, 16),     # the narrowest the mma tiles pad
])
def test_attention_kernel_matches_plain(cuda_device, dtype, lq, lk, dk, dv):
    q = _rand((2, 3, lq, dk), cuda_device, dtype, 0, dk ** -0.5)
    k = _rand((2, 3, lk, dk), cuda_device, dtype, 1)
    v = _rand((2, 3, lk, dv), cuda_device, dtype, 2)
    got = flash_attention(q, k, v, 0.2)
    assert got.dtype == dtype and got.shape == (2, 3, lq, dv)
    _close(got, attention_reference(q, k, v, 0.2), _attn_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [0, 1])
@pytest.mark.parametrize("b,n,nh", [(2, 300, 4), (16, 14336, 1)], ids=["small", "stage0"])
def test_attention_kernel_takes_strided_head_views(cuda_device, b, n, nh, group, dtype):
    """The pooled branch hands the kernel q and k as views of (B, N, nh, 2, hd),
    group 1 starting 24 elements in, and v as a view of (B, 56, nh, 48)."""
    qg = _rand((b, n, nh, 2, 24), cuda_device, dtype, 0, 0.2)
    kg = _rand((b, 56, nh, 2, 24), cuda_device, dtype, 1)
    v = _rand((b, 56, nh, 48), cuda_device, dtype, 2).transpose(1, 2)
    q, k = qg[:, :, :, group].transpose(1, 2), kg[:, :, :, group].transpose(1, 2)
    _close(flash_attention(q, k, v, 0.2), attention_reference(q, k, v, 0.2), _attn_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_takes_more_than_65535_heads(cuda_device, dtype):
    """b * h = 70,000 on the 1-D grid."""
    q = _rand((2, 35000, 10, 8), cuda_device, dtype, 0, 0.3)
    k = _rand((2, 35000, 12, 8), cuda_device, dtype, 1)
    v = _rand((2, 35000, 12, 16), cuda_device, dtype, 2)
    _close(flash_attention(q, k, v, 0.3), attention_reference(q, k, v, 0.3), _attn_tol(dtype))


def test_attention_kernel_bf16_runs_bit_equal(cuda_device):
    """No atomics, a fixed reduction order: two runs give the same bits."""
    qg = _rand((4, 3584, 2, 2, 24), cuda_device, torch.bfloat16, 0, 0.2)
    kg = _rand((4, 56, 2, 2, 24), cuda_device, torch.bfloat16, 1)
    v = _rand((4, 56, 2, 48), cuda_device, torch.bfloat16, 2).transpose(1, 2)
    q, k = qg[:, :, :, 1].transpose(1, 2), kg[:, :, :, 1].transpose(1, 2)
    first = flash_attention(q, k, v, 0.2)
    assert torch.equal(first, flash_attention(q, k, v, 0.2))


def test_wrappers_raise_on_what_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 1, 8, 8, device=cuda_device)
    with pytest.raises(ValueError):  # dv = 0
        flash_attention(q, q, torch.zeros(1, 1, 8, 0, device=cuda_device))
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    x = torch.zeros(4, 8, 32, device=cuda_device)
    w = torch.zeros(32, 32, device=cuda_device)
    bias = torch.zeros(32, device=cuda_device)
    with pytest.raises(ValueError):  # mixed dtypes
        mlla_front(x, bias, bias, w, bias, w, bias.double())
    z16 = lambda *shape: torch.zeros(*shape, device=cuda_device, dtype=torch.bfloat16)  # noqa: E731
    with pytest.raises(ValueError):  # bf16 front: C = 48 is not a multiple of 32
        mlla_front(z16(4, 8, 48), z16(48), z16(48), z16(48, 48), z16(48), z16(48, 48), z16(48))
    with pytest.raises(ValueError):  # bf16 tail: Hd = 48 is not a multiple of 32
        mlla_tail(z16(4, 8, 32), z16(4, 8, 32), z16(4, 8, 32), z16(32, 32), z16(32), z16(32),
                  z16(32), z16(48, 32), z16(48), z16(32, 48), z16(32))
    u = torch.zeros(1, 1, 4, 10, device=cuda_device)
    with pytest.raises(ValueError):  # 8 states: the kernel takes 16
        selective_scan_fwd(u, u, torch.zeros(1, 4, 8, device=cuda_device),
                           torch.zeros(1, 1, 8, 10, device=cuda_device),
                           torch.zeros(1, 1, 8, 10, device=cuda_device))
    A, B = torch.zeros(1, 4, 16, device=cuda_device), torch.zeros(1, 1, 16, 10, device=cuda_device)
    _, states = selective_scan_fwd_states(u, u, A, B, B)
    with pytest.raises(ValueError):  # K5: states of another length
        selective_scan_bwd(u, u, A, B, B, gy=u, states=states[:, :, :0])
    with pytest.raises(ValueError):  # K5: no output gradient
        selective_scan_bwd(u, u, A, B, B, states=states)


def test_model_on_card_matches_cpu(cuda_device):
    """A small flagship, fp32, the card's kernels against the CPU's twins."""
    from mlagg_unet_torch import build_flagship

    tiny = dict(embed_dim=32, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
                sr_ratio=(8, 4, 2, 2))
    model = build_flagship(3, device=cuda_device, seed=1, **tiny)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 96, 1).astype(np.float32))
    with torch.inference_mode():
        gpu = model(x.to(cuda_device))
        cpu = build_flagship(3, device="cpu", seed=1, **tiny)(x)
    for g_, c_ in zip(gpu, cpu):
        err = (g_.cpu() - c_).abs().max().item()
        assert err <= 1e-3 * c_.abs().max().item(), err


def _local_args(dev, dtype, B, H, W, ch, nh, seed=0):
    """Weights in torch's layouts, lam as a device fp32 scalar."""
    hd = ch // nh // 2
    x = _rand((B, H, W, ch), dev, dtype, seed, 0.5)
    params = (_rand((ch, ch), dev, dtype, seed + 1, ch ** -0.5),
              _rand((ch,), dev, dtype, seed + 2, 0.1),
              _rand((2 * ch, ch), dev, dtype, seed + 3, ch ** -0.5),
              _rand((2 * ch,), dev, dtype, seed + 4, 0.1),
              (1 + _rand((2 * hd,), dev, torch.float32, seed + 5, 0.2)).to(dtype),
              _rand((ch, 1, 3, 3), dev, dtype, seed + 6, 1 / 3),
              _rand((ch,), dev, dtype, seed + 7, 0.1))
    lam = torch.tensor(0.37, device=dev)
    return x, params, lam, nh


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,ch,nh", [(2, 13, 11, 48, 1), (3, 8, 7, 96, 2),
                                         (2, 16, 14, 384, 8), (1, 5, 1, 192, 4)])
def test_local_attn_kernel_matches_plain(cuda_device, dtype, B, H, W, ch, nh):
    """K6 at odd maps (and a one-column one), every stage width, fp32 and bf16."""
    x, params, lam, nh = _local_args(cuda_device, dtype, B, H, W, ch, nh)
    got = local_aggregated_attention_fused(x, *params, lam, nh)
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, local_attention_fused_plain(x, *params, lam, nh),
           1e-4 if dtype == torch.float32 else 2e-2)


def test_local_attn_kernel_takes_a_channel_slice(cuda_device):
    """The block hands K6 the first half of a (B, H, W, 2 ch) map."""
    x, params, lam, nh = _local_args(cuda_device, torch.float32, 2, 9, 10, 96, 2)
    wide = torch.cat([x, torch.randn_like(x)], dim=-1)
    half = wide[..., :96]
    assert not half.is_contiguous()
    _close(local_aggregated_attention_fused(half, *params, lam, nh),
           local_attention_fused_plain(x, *params, lam, nh))


@pytest.mark.parametrize("B,H,W,ch,nh", [
    (2, 13, 11, 48, 1),     # an odd map inside one tile
    (16, 128, 112, 48, 1),  # the four stages at model batch 16
    (16, 64, 56, 96, 2),
    (16, 32, 28, 192, 4),
    (16, 16, 14, 384, 8),
    (1, 17, 15, 48, 1),     # two row tiles, the last of one row
    (3, 9, 29, 96, 2),      # two column tiles, the last of one column
    (3, 17, 31, 96, 2),     # 2 x 2 ragged tiles
    (2, 33, 7, 192, 4),     # three row tiles
    (2, 19, 23, 384, 8),    # two row tiles at the widest stage
    (2, 33, 57, 384, 8),    # 16 x 14 tiles: 16 x 28 ones leave too little shared memory
    (1, 1, 9, 96, 2),       # one row
    (2, 5, 1, 192, 4),      # one column
    (1, 1, 1, 384, 8),      # one token: every neighbour outside the map
])
def test_local_attn_mma_kernel_matches_twin(cuda_device, B, H, W, ch, nh):
    """K6 in bf16 (``local_attn_mma_kernel``) at every stage width with odd
    and ragged maps: within 1e-2 of the plain twin, which rounds where the
    kernel rounds (k and v, the output), and two runs bit-equal."""
    x, params, lam, nh = _local_args(cuda_device, torch.bfloat16, B, H, W, ch, nh)
    got = local_aggregated_attention_fused(x, *params, lam, nh)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _close(got, local_attention_fused_plain(x, *params, lam, nh), 1e-2)
    assert torch.equal(got, local_aggregated_attention_fused(x, *params, lam, nh))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_local_attn_kernels_take_a_channel_slice_bit_equal(cuda_device, dtype):
    """Both halves of a (B, H, W, 2 ch) map, read in place (tokens 2 ch
    apart), give the bits of their contiguous copies."""
    x, params, lam, nh = _local_args(cuda_device, dtype, 2, 19, 17, 192, 4)
    wide = torch.cat([x, _rand(x.shape, cuda_device, dtype, 9)], dim=-1)
    for half in (wide[..., :192], wide[..., 192:]):
        assert not half.is_contiguous()
        got = local_aggregated_attention_fused(half, *params, lam, nh)
        assert torch.equal(got, local_aggregated_attention_fused(half.contiguous(), *params,
                                                                 lam, nh))


def test_local_attn_mma_kernel_raises_under_grad_and_on_unaligned_tokens(cuda_device):
    x, params, lam, nh = _local_args(cuda_device, torch.bfloat16, 1, 4, 4, 96, 2)
    params[2].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        local_aggregated_attention_fused(x, *params, lam, nh)
    with torch.no_grad():
        local_aggregated_attention_fused(x, *params, lam, nh)
        odd = torch.zeros(1, 4, 4, 100, device=cuda_device, dtype=torch.bfloat16)[..., :96]
        with pytest.raises(ValueError, match="16-byte"):  # tokens 200 bytes apart
            local_aggregated_attention_fused(odd, *params, lam, nh)


def test_local_attn_kernel_raises_under_grad(cuda_device):
    x, params, lam, nh = _local_args(cuda_device, torch.float32, 1, 4, 4, 48, 1)
    params[0].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        local_aggregated_attention_fused(x, *params, lam, nh)
    with torch.no_grad():
        local_aggregated_attention_fused(x, *params, lam, nh)
        with pytest.raises(ValueError):  # head_dim 20 is not built
            local_aggregated_attention_fused(
                torch.zeros(1, 4, 4, 40, device=cuda_device), *params, lam, 1)


def _norm_args(dev, dtype, mode, shape, seed=0):
    C = shape[-1]
    x = (_rand(shape, dev, torch.float32, seed, 2.0) + 0.5).to(dtype)
    s = 1 + _rand((C,), dev, torch.float32, seed + 1, 0.2)
    b = _rand((C,), dev, torch.float32, seed + 2, 0.1)
    kw = {}
    if mode:
        kw["residual"] = _rand(shape, dev, dtype, seed + 3)
    if mode == 2:
        kw["res_scale"] = 1 + _rand((C,), dev, torch.float32, seed + 4, 0.2)
        kw["res_bias"] = _rand((C,), dev, torch.float32, seed + 5, 0.1)
    return x, s, b, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("shape", [(3, 37, 29, 48), (2, 9, 7, 5)], ids=["vector", "scalar"])
def test_instance_norm_kernels_match_plain(cuda_device, shape, mode, act, dtype):
    """K7 + K8 in every mode, with 16-byte vectors along C (C = 48) and on the
    scalar path (C = 5); two runs give the same bits."""
    x, s, b, kw = _norm_args(cuda_device, dtype, mode, shape)
    got = fused_instance_norm(x, s, b, act=act, **kw)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, fused_instance_norm(x, s, b, act=act, **kw))
    _close(got, instance_norm_plain(x, s, b, act=act, **kw),
           1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_instance_norm_autograd_on_card_matches_plain(cuda_device, mode):
    """K7 + K8 forward under autograd on the card; every gradient equals the
    CPU's (the backward recomputes the plain twin)."""
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        x, s, b, kw = _norm_args(cuda_device, torch.float32, mode, (2, 20, 12, 48), seed=mode)
        leaves = [t.to(dev).requires_grad_() for t in (x, s, b, *kw.values())]
        out = fused_instance_norm(*leaves[:3], act=True, **dict(zip(kw, leaves[3:])))
        (out * torch.linspace(-1, 1, out.shape[-1], device=dev)).sum().backward()
        grads.append([t.grad for t in leaves])
    for g_, r_ in zip(*grads):
        _close(g_, r_)


def test_fused_model_on_card_matches_default(cuda_device):
    """A small flagship in the fused config (K1-K4, K6-K8) against the
    default config on the card, same seed, fp32, eval."""
    from mlagg_unet_torch import build_flagship

    tiny = dict(embed_dim=96, depths=(1, 1, 1, 1), num_heads=(2, 4, 8, 16),
                sr_ratio=(8, 4, 2, 2))
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 96, 1).astype(np.float32))
    outs = []
    for fused in (False, True):
        model = build_flagship(3, device=cuda_device, seed=1, fused_local_attn=fused,
                               fused_instance_norm=fused, **tiny)
        with torch.inference_mode():
            outs.append(model(x.to(cuda_device)))
    for g_, r_ in zip(*outs):
        _close(g_, r_, 1e-3)
