"""The Mamba zoo's first family in the PyTorch port against the JAX package on
the CPU (fp32, and bf16 against JAX's bf16): U-Mamba Bot / Enc in 2-D and
3-D, VM-UNet, Mamba-UNet, Swin-UMamba and Swin-UMamba-D at tiny widths,
their param trees both ways, their reference ``.pth`` converters, the
trainer names, and ``run_training`` of a tiny U-Mamba Bot.

Weights come from numpy seeds into the JAX param tree
(``test_torch_port_mamba.mamba_params``), then
``jax_params_to_state_dict`` -> ``load_state_dict(strict=True)``; inputs from
numpy seeds. Every fp32 output is held within 1e-4 x max|ref| (+1e-5), a
bf16 output within twice the distance bf16 moves JAX's own network; the
training run's logged losses and pseudo dice within 1e-4.
"""
import copy
import dataclasses
import os
import re
from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_tpu.models import swin_umamba as JSU
from mlagg_unet_tpu.models import umamba as JUM
from mlagg_unet_tpu.models import vmamba as JVM
from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_tpu.training import torch_import as jti
from mlagg_unet_tpu.training.trainer import NNUNetTrainerTPU
from mlagg_unet_torch.models import swin_umamba as TSU
from mlagg_unet_torch.models import umamba as TUM
from mlagg_unet_torch.models import vmamba as TVM
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training import torch_import as tti
from mlagg_unet_torch.training.trainer import NNUNetTrainer, _check_ported
from mlagg_unet_torch.weights import jax_params_to_state_dict, state_dict_to_jax_params
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    TINY_DATASET_JSON, assert_close, flat_params, one_torch_thread, set_paths, tiny_plans)
from test_torch_port_mamba import load, mamba_params

T = torch.from_numpy

# tiny plans: 2-D puts stage 3 (4x4 = 16 <= 16 channels) in channel-token
# mode, 3-D stages 2 (2x4x4 = 32 <= 32) and 3 (1x2x2 = 4 <= 32); Enc 2-D has
# Mamba layers after stages 1 and 3, Enc 3-D after every stage (stage 0:
# 2048 tokens). At 3-D widths 4-16 this network is ill-conditioned: JAX's own
# output moves by up to 3.4e-4 x max under a 1e-7 relative change of the
# input, so the 3-D plan runs at widths 8-32 (2e-5 to 3e-5 there).
CM_2D = SimpleNamespace(
    patch_size=[32, 32], pool_op_kernel_sizes=[[1, 1], [2, 2], [2, 2], [2, 2]],
    conv_kernel_sizes=[[3, 3]] * 4, UNet_base_num_features=4, unet_max_num_features=16,
    n_conv_per_stage_encoder=[2, 2, 2, 2], n_conv_per_stage_decoder=[2, 2, 2])
CM_3D = SimpleNamespace(
    patch_size=[8, 16, 16], pool_op_kernel_sizes=[[1, 1, 1], [2, 2, 2], [2, 2, 2], [2, 2, 2]],
    conv_kernel_sizes=[[1, 3, 3], [3, 3, 3], [3, 3, 3], [3, 3, 3]], UNet_base_num_features=8,
    unet_max_num_features=32, n_conv_per_stage_encoder=[2, 2, 2, 2],
    n_conv_per_stage_decoder=[2, 2, 2])
DIMS = (8, 16, 32, 64)
# VM-UNet's last LayerNorm normalises dims[0] / 4 channels: at dims[0] = 8
# two, and JAX's own output then moves by 3.8e-3 x max under a 1e-7
# relative change of the input; at 16 (four channels) by under 1e-5
VMUNET_DIMS = (16, 32, 64, 128)
# Enc 3-D runs four Mamba layers and norms over a few voxels in fp32: JAX's
# own fp32 output is 1.9e-4 x max from its fp64 one there, the port's 3.8e-5;
# its reference is JAX in fp64
FP64_REFERENCE = ("umamba_enc_3d",)


def _x(shape, seed=0):
    return jnp.asarray(np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _umamba(dim, mode):
    cm = CM_2D if dim == 2 else CM_3D
    return (JUM.umamba_from_plans(cm, 1, 3, True, mode),
            TUM.umamba_from_plans(cm, 1, 3, True, mode), _x((2, *cm.patch_size, 1)))


# name: (JAX module, port module, input, network key of the converter)
def _networks():
    return {
        "umamba_bot_2d": (*_umamba(2, "bot"), "umamba_bot"),
        "umamba_enc_2d": (*_umamba(2, "enc"), "umamba_enc"),
        "umamba_bot_3d": (*_umamba(3, "bot"), "umamba_bot"),
        "umamba_enc_3d": (*_umamba(3, "enc"), "umamba_enc"),
        "vmunet": (JVM.VMUNet(num_classes=3, dims=VMUNET_DIMS),
                   TVM.VMUNet(1, 3, dims=VMUNET_DIMS), _x((1, 64, 64, 1)), "vmunet"),
        "mamba_unet": (JVM.MambaUNet(num_classes=3, dims=DIMS), TVM.MambaUNet(1, 3, dims=DIMS),
                       _x((1, 64, 64, 1)), "mamba_unet"),
        "swin_umamba": (JSU.SwinUMamba(num_classes=2, feat_size=(4, 8, 16, 32, 64),
                                       hidden_size=64, vssm_depths=(1, 1, 1, 1),
                                       deep_supervision=True),
                        TSU.SwinUMamba(1, 2, feat_size=(4, 8, 16, 32, 64), hidden_size=64,
                                       vssm_depths=(1, 1, 1, 1), deep_supervision=True),
                        _x((1, 64, 64, 1)), "swin_umamba"),
        "swin_umamba_d": (JSU.SwinUMambaD(num_classes=2, dims=DIMS, deep_supervision=True),
                          TSU.SwinUMambaD(1, 2, dims=DIMS, deep_supervision=True),
                          _x((1, 64, 64, 1)), "swin_umamba_d"),
    }


NAMES = list(_networks())


@pytest.fixture(scope="module")
def nets():
    """Each network of both packages with one seeded param tree, and JAX's
    output on the seeded input (jitted)."""
    out = {}
    for i, (name, (jm, tm, x, key)) in enumerate(_networks().items()):
        params = mamba_params(jm, x, seed=i)
        apply = jax.jit(jm.apply)
        if name in FP64_REFERENCE:
            with jax.enable_x64():
                f64 = lambda t: jnp.asarray(np.asarray(t), jnp.float64)  # noqa: E731
                ref = [np.asarray(r, np.float32) for r in _outputs(jax.jit(jm.apply)(
                    {"params": jax.tree_util.tree_map(f64, params)}, f64(x)))]
        else:
            ref = apply({"params": params}, x)
        out[name] = dict(jm=jm, apply=apply, tm=load(tm, params), x=x, key=key, params=params,
                         ref=ref)
    return out


def _outputs(o):
    return list(o) if isinstance(o, (list, tuple)) else [o]


@pytest.mark.parametrize("name", NAMES)
def test_network_matches_jax(nets, name):
    """Every output (each deep-supervision scale) of the port's network
    equals JAX's within 1e-4 (U-Mamba Enc 3-D: JAX's in fp64)."""
    n = nets[name]
    with torch.no_grad():
        got = _outputs(n["tm"](T(np.array(n["x"]))))
    ref = _outputs(n["ref"])
    assert len(got) == len(ref) >= 1
    for g, r in zip(got, ref):
        assert_close(g, np.asarray(r))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name", NAMES)
def test_bf16_network_follows_jax(nets, name):
    """In bf16 (parameters and input cast, as both predictors do) the port
    computes JAX's function: every output answers in JAX's dtype (fp32: the
    Mamba blocks' fp32 output promotes the layers after them), the port's
    bf16 output sits from its fp32 output within twice the distance JAX's
    sits from JAX's fp32 output, and from JAX's bf16 output within twice
    that distance too. Two bf16 implementations of these networks differ by
    about what bf16 itself moves them (measured: 0.5-1.2x JAX's own gap,
    which is 1.5e-2 to 5.2e-1 here), so the distance is held to the
    network's own gap and not to a fixed tolerance."""
    n = nets[name]
    p16 = jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16), n["params"])
    j16 = _outputs(n["apply"]({"params": p16}, n["x"].astype(jnp.bfloat16)))
    j32 = _outputs(n["apply"]({"params": n["params"]}, n["x"]))
    x = T(np.array(n["x"]))
    with torch.no_grad():
        t32 = _outputs(n["tm"](x))
        t16 = _outputs(copy.deepcopy(n["tm"]).to(torch.bfloat16)(x.to(torch.bfloat16)))
    assert len(t16) == len(j16)
    for a, b in zip(t16, j16):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
    gap = _rel_l2(np.asarray(j16[0], np.float32), np.asarray(j32[0]))
    assert 0 < _rel_l2(t16[0].float(), t32[0]) <= 2 * gap
    assert _rel_l2(t16[0].float(), np.asarray(j16[0], np.float32)) <= 2 * gap


def test_umamba_channel_token_stages():
    """The channel-token rule and the alternating 2-D placement: Enc 2-D
    scans after stages 1 and 3, stage 3 over its 16 channels (d_model = its
    4x4 map); Enc 3-D after every stage, stages 2 and 3 over channels
    (d_model 32 and 4); Bot only at the bottleneck, over tokens; the SS3D
    modes raise."""
    enc2 = TUM.umamba_from_plans(CM_2D, 1, 3, True, "enc")
    assert enc2.mamba_stages == [1, 3]
    assert enc2.enc_mamba3.channel_token and enc2.enc_mamba3.mamba.d_inner == 32
    assert not enc2.enc_mamba1.channel_token and enc2.enc_mamba1.mamba.d_inner == 16
    enc3 = TUM.umamba_from_plans(CM_3D, 1, 3, True, "enc")
    assert enc3.mamba_stages == [0, 1, 2, 3]
    assert [getattr(enc3, f"enc_mamba{s}").channel_token for s in range(4)] == [
        False, False, True, True]
    assert enc3.enc_mamba2.mamba.d_inner == 64 and enc3.enc_mamba3.mamba.d_inner == 8
    bot = TUM.umamba_from_plans(CM_2D, 1, 3, False, "bot")
    assert bot.mamba_stages == [] and not bot.bot_mamba.channel_token
    for mode in ("bot_ss3d", "enc_ss3d"):
        with pytest.raises(NotImplementedError, match="A16"):
            TUM.umamba_from_plans(CM_3D, 1, 3, True, mode)


@pytest.mark.parametrize("name", NAMES)
def test_param_tree_round_trip(nets, name):
    """JAX tree -> state_dict -> JAX tree, exactly, for every parameter."""
    flat = flat_params(nets[name]["params"])
    back = state_dict_to_jax_params(jax_params_to_state_dict(flat), flat)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


# --------------------------------------------------------------- reference .pth
_SWIN_SHARED = [
    (r"^vssm_encoder\.patch_embed_proj\.", "vssm_encoder.patch_embed.proj."),
    (r"^vssm_encoder\.patch_embed_norm\.", "vssm_encoder.patch_embed.norm."),
    (r"^vssm_encoder\.layer(\d+)\.block(\d+)\.", r"vssm_encoder.layers.\1.blocks.\2."),
    (r"^vssm_encoder\.downsample(\d+)\.", r"vssm_encoder.downsamples.\1."),
]
# the port's (flax's) names -> the reference's, the inverse of each family's
# REFERENCE_*_RULES
_TO_REFERENCE = {
    "umamba_bot": [
        (r"^stem_block(\d+)\.", r"encoder.stem.\1."),
        (r"^stage(\d+)_block(\d+)\.", r"encoder.stages.\1.\2."),
        (r"^enc_mamba(\d+)\.", r"encoder.mamba_layers.\1."),
        (r"^bot_mamba\.", "mamba_layer."),
        (r"^up(\d+)\.", r"decoder.upsample_layers.\1."),
        (r"^dec_stage(\d+)_block(\d+)\.", r"decoder.stages.\1.\2."),
        (r"^seg(\d+)\.", r"decoder.seg_layers.\1."),
        (r"\.GroupNorm_0\.", "."),
    ],
    "vmunet": [
        (r"^patch_embed\.", "vmunet.patch_embed.proj."),
        (r"^patch_norm\.", "vmunet.patch_embed.norm."),
        (r"^layer(\d+)_block(\d+)\.", r"vmunet.layers.\1.blocks.\2."),
        (r"^downsample(\d+)\.", r"vmunet.layers.\1.downsample."),
        (r"^uplayer(\d+)_block(\d+)\.", r"vmunet.layers_up.\1.blocks.\2."),
        (r"^up(\d+)\.", r"vmunet.layers_up.\1.upsample."),
        (r"^(final_up|final_conv)\.", r"vmunet.\1."),
    ],
    "mamba_unet": [
        (r"^patch_embed\.", "patch_embed.proj."),
        (r"^patch_norm\.", "patch_embed.norm."),
        (r"^layer(\d+)_block(\d+)\.", r"layers.\1.blocks.\2."),
        (r"^downsample(\d+)\.", r"layers.\1.downsample."),
        (r"^up0\.", "layers_up.0."),
        (r"^uplayer(\d+)_block(\d+)\.", r"layers_up.\1.blocks.\2."),
        (r"^up(\d+)\.", r"layers_up.\1.upsample."),
        (r"^concat_back(\d+)\.", r"concat_back_dim.\1."),
    ],
    "swin_umamba": _SWIN_SHARED + [
        (r"^stem_conv\.", "stem.0."),
        (r"^stem_norm\.GroupNorm_0\.", "stem.1."),
        (r"^out(\d+)\.conv\.", r"out_layers.\1.conv.conv."),
        (r"\.transp_conv\.", ".transp_conv.conv."),
        (r"\.(conv1|conv2|conv3)\.", r".\1.conv."),
        (r"\.(norm1|norm2|norm3)\.GroupNorm_0\.", r".\1."),
    ],
    "swin_umamba_d": _SWIN_SHARED + [
        (r"^expand(\d+)\.", r"decoder.expand_layers.\1."),
        (r"^stage(\d+)\.block(\d+)\.", r"decoder.stages.\1.blocks.\2."),
        (r"^concat_back_dim(\d+)\.", r"decoder.concat_back_dim.\1."),
        (r"^seg(\d+)\.", r"decoder.seg_layers.\1."),
    ],
}
_TO_REFERENCE["umamba_enc"] = _TO_REFERENCE["umamba_bot"]
_REF_TRANSPOSED = re.compile(r"transp_conv(\.conv)?\.weight$")


def _reference_state_dict(flat, key):
    """A reference-named, reference-layout torch state_dict of flax params."""
    sd = {}
    for name, arr in flat.items():
        *path, leaf = name.split("/")
        prefix = ".".join(path) + "."
        for pat, rep in _TO_REFERENCE[key]:
            prefix = re.sub(pat, rep, prefix)
        if leaf == "kernel":
            leaf = "weight"
            if arr.ndim >= 3:
                transposed = _REF_TRANSPOSED.search(prefix + leaf) and arr.shape[-1] != 1
                arr = np.moveaxis(arr, (-2, -1), (0, 1)) if transposed else \
                    np.moveaxis(arr, (-1, -2), (0, 1))
            else:
                arr = arr.T
        elif leaf == "scale":
            leaf = "weight"
        elif leaf == "A_logs":
            arr = arr.reshape(-1, arr.shape[-1])
        elif leaf == "Ds":
            arr = arr.reshape(-1)
        elif leaf == "A_log":
            arr = arr[0]
        elif leaf in ("dt_proj_weight", "dt_proj_bias"):
            leaf = "dt_proj." + leaf[len("dt_proj_"):]
        sd[prefix + leaf] = torch.from_numpy(np.array(arr))
    return sd


@pytest.mark.parametrize("name", NAMES)
def test_reference_pth_converts_and_loads_strict(nets, name):
    """A reference-format state_dict of the same weights maps back through
    JAX's converter exactly; the port's converter (``CONVERTERS_BY_NETWORK``
    composed with ``jax_params_to_state_dict``) loads it strict, and the
    network then matches JAX's forward."""
    n = nets[name]
    flat = flat_params(n["params"])
    sd = {"module." + k: v for k, v in _reference_state_dict(flat, n["key"]).items()}
    back = jti.convert_reference_network_state_dict(n["key"], sd)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    tm = n["tm"]
    tm.load_state_dict(tti.reference_state_dict_to_port(n["key"], sd), strict=True)
    with torch.no_grad():
        got = _outputs(tm(T(np.array(n["x"]))))
    for g, r in zip(got, _outputs(n["ref"])):
        assert_close(g, np.asarray(r))


def test_pretrained_pth_transfer_and_raises(nets, tmp_path):
    """``load_pretrained_torch_weights`` of a reference VM-UNet ``.pth``
    transfers every tensor into a fresh port network; a network without a
    converter and a checkpoint of another family raise naming A16."""
    n = nets["vmunet"]
    path = str(tmp_path / "vmunet.pth")
    torch.save({"network_weights": _reference_state_dict(flat_params(n["params"]), "vmunet")},
               path)
    fresh = TVM.VMUNet(1, 3, dims=VMUNET_DIMS)
    n_tr, n_tot = tti.load_pretrained_torch_weights(fresh, path, network_key="vmunet")
    assert n_tr == n_tot == len(fresh.state_dict())
    for k, v in n["tm"].state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    with pytest.raises(NotImplementedError, match="A16"):
        tti.load_pretrained_torch_weights(fresh, path, network_key="segmamba")
    with pytest.raises(NotImplementedError, match="A16"):
        tti.load_pretrained_torch_weights(nets["mamba_unet"]["tm"], path,
                                          network_key="umamba_bot")


# ---------------------------------------------------------------- the trainer names
PORTED = ("nnUNetTrainerUMambaBot", "nnUNetTrainerUMambaEnc", "nnUNetTrainer_VMUNet",
          "nnUNetTrainer_MambaUNet", "nnUNetTrainerSwinUMambaScratch",
          "nnUNetTrainerSwinUMambaDScratch", "nnUNetTrainerVMUNet", "nnUNetTrainerMambaUNet")
ZOO = [k for k, v in jreg.TRAINER_REGISTRY.items()
       if v.network not in ("plans_unet", "plans_unet_bn", "mlla_uper")]


@pytest.mark.parametrize("name", PORTED)
def test_ported_zoo_trainer_resolves(name):
    """The family's names (and the two aliases of its networks) resolve with
    JAX's field values and pass the port's check."""
    got = treg.get_trainer_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jreg.get_trainer_config(name))
    _check_ported(got)


@pytest.mark.parametrize("name", [k for k in ZOO if k not in PORTED])
def test_unported_zoo_trainer_raises(name):
    """Every other zoo name resolves with JAX's values and raises at the
    check, naming A16."""
    got = treg.get_trainer_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jreg.get_trainer_config(name))
    with pytest.raises(NotImplementedError, match="A16"):
        _check_ported(got)


def test_builders_follow_jax():
    """The registry's builders: U-Mamba from the plans only, the 2-D
    networks refuse a 3-D plan, deep supervision where the network has it,
    the recipes' optimizers and schedules as JAX's."""
    cm = SimpleNamespace(**vars(CM_2D))
    net = treg.get_network_builder("umamba_enc")(cm, 1, 3, False, device="cpu")
    assert isinstance(net, TUM.UMambaUNet) and not net.training and not net.deep_supervision
    with pytest.raises(ValueError, match="ConfigurationManager"):
        treg.get_network_builder("umamba_bot")((32, 32), 1, 3, True, device="cpu")
    with pytest.raises(ValueError, match="2D"):
        treg.get_network_builder("vmunet")((8, 16, 16), 1, 3, False, device="cpu")
    sw = treg.get_network_builder("swin_umamba_d")((64, 64), 1, 2, True, device="cpu",
                                                   dims=DIMS)
    assert sw.deep_supervision and hasattr(sw, "seg0")
    vm = treg.get_trainer_config("nnUNetTrainer_VMUNet")
    assert (vm.optimizer, vm.initial_lr, vm.weight_decay, vm.lr_scheduler,
            vm.enable_deep_supervision) == ("adamw", 1e-4, 1e-3, "cosine_warmup", False)
    assert treg.get_trainer_config("nnUNetTrainer_MambaUNet").initial_lr == 1e-3


# ---------------------------------------------------------------- run_training
DATASET = "Dataset991_PortUMamba"
TR = "nnUNetTrainerUMambaBot_PortTiny"
EPOCHS, STEPS, VAL_STEPS = 2, 2, 1


def _tiny_umamba_plans():
    """3 stages (an 8x8 bottleneck of 16 channels). With CM_2D's 4 stages
    the run is chaotic at the recipe's SGD step: JAX's own epoch-2
    validation loss moves by 3.4e-4 under a 1e-7 relative change of its
    init; here by 1.5e-6."""
    plans = tiny_plans(DATASET)
    plans["configurations"]["2d"].update(
        pool_op_kernel_sizes=[[1, 1], [2, 2], [2, 2]], conv_kernel_sizes=[[3, 3]] * 3,
        UNet_base_num_features=4, unet_max_num_features=16,
        n_conv_per_stage_encoder=[2, 2, 2], n_conv_per_stage_decoder=[2, 2])
    return plans


class _SeqLoader:
    def __init__(self, batches, per_epoch, cycle=False):
        self.batches, self.per_epoch, self.cycle, self.pos = batches, per_epoch, cycle, 0

    def __iter__(self):
        for _ in range(self.per_epoch):
            yield self.get_batch()

    def get_batch(self):
        batch = self.batches[self.pos % len(self.batches) if self.cycle else self.pos]
        self.pos += 1
        return batch

    def stop(self):
        pass


def _batches(n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.randn(2, 32, 32, 1).astype(np.float32)
        y = ((x[..., 0] > 0.2).astype(np.int32) + (x[..., 0] > 1.0)).astype(np.int32)
        out.append({"data": x, "target": y})
    return out


def _stand_in_loaders(trainer, train, val):
    def get_dataloaders():
        trainer.dataloader_train = _SeqLoader(train, STEPS)
        trainer.dataloader_val = _SeqLoader(val, VAL_STEPS, cycle=True)
        return trainer.dataloader_train, trainer.dataloader_val
    trainer.get_dataloaders = get_dataloaders


class _NumpyInitUMamba(JUM.UMambaUNet):
    """JAX's U-Mamba with its init drawn from numpy (``mamba_params``), not
    flax's threefry init."""

    def init(self, rngs, *args, **kwargs):
        plain = JUM.UMambaUNet(**_fields(self), parent=None)
        return {"params": mamba_params(plain, *args)}


def _fields(module):
    return {f.name: getattr(module, f.name) for f in dataclasses.fields(JUM.UMambaUNet)
            if f.name not in ("parent", "name")}


def _jax_tiny_builder(cm, cin, cout, ds):
    return _NumpyInitUMamba(**_fields(JUM.umamba_from_plans(cm, cin, cout, ds, "bot")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """run_training of the tiny U-Mamba Bot recipe (SGD, poly, deep
    supervision; fp32) in both packages from JAX's init, on one batch
    sequence."""
    root = tmp_path_factory.mktemp("port_umamba_train")
    plans = _tiny_umamba_plans()
    with pytest.MonkeyPatch.context() as mp:
        set_paths(mp, root)
        net = TR + "_network"
        mp.setitem(jreg.NETWORK_BUILDERS, net, _jax_tiny_builder)
        mp.setitem(treg.NETWORK_BUILDERS, net, treg.NETWORK_BUILDERS["umamba_bot"])
        for reg in (jreg, treg):
            mp.setitem(reg.TRAINER_REGISTRY, TR, replace(
                reg.TRAINER_REGISTRY["nnUNetTrainerUMambaBot"], name=TR, network=net,
                num_epochs=EPOCHS, num_iterations_per_epoch=STEPS,
                num_val_iterations_per_epoch=VAL_STEPS, compute_dtype="float32"))
        train, val = _batches(EPOCHS * STEPS, 1), _batches(1, 2)
        jtr = NNUNetTrainerTPU(plans, "2d", 0, TINY_DATASET_JSON, trainer_name=TR,
                               unpack_data=False, num_devices=1)
        jtr.initialize()
        init = {k: np.array(v) for k, v in flat_params(jtr.params).items()}
        _stand_in_loaders(jtr, train, val)
        jtr.run_training()
        ttr = NNUNetTrainer(plans, "2d", 0, TINY_DATASET_JSON, trainer_name=TR,
                            unpack_data=False, device="cpu")
        ttr.initialize()
        ttr.step.network.load_state_dict(jax_params_to_state_dict(init), strict=True)
        _stand_in_loaders(ttr, train, val)
        ttr.run_training()
        yield jtr, ttr


@pytest.mark.parametrize("key", ["train_losses", "val_losses", "mean_fg_dice"])
def test_umamba_run_training_matches_jax(runs, key):
    """The logged series of both runs within 1e-4 relative, and the port's
    checkpoint_final written."""
    jtr, ttr = runs
    got = ttr.logger.my_fantastic_logging[key]
    ref = jtr.logger.my_fantastic_logging[key]
    assert len(got) == len(ref) == EPOCHS
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=1e-4, atol=1e-7)
    assert os.path.isfile(os.path.join(ttr.output_folder, "checkpoint_final.ckpt"))
