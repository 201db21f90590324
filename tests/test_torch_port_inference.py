"""The PyTorch port's VolumePredictor and tiling helpers against the JAX
package's (fp32, max|diff| <= 1e-4 * max|ref| + 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest

from mlagg_unet_tpu.inference import sliding_window as jsw
from mlagg_unet_tpu.models.mlla_uper import MLLAUper as JaxMLLAUper
from mlagg_unet_torch.inference import sliding_window as tsw
from mlagg_unet_torch.models.mlla_uper import MLLAUper
from port_helpers import load_jax_params, one_torch_thread, random_jax_params  # noqa: F401

TINY = dict(embed_dim=16, patch_size=2, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
            mlp_ratio=2, sr_ratio=(8, 4, 2, 2))


def test_volume_predictor_z_mode_matches_jax():
    """2D tiles over a 3D volume (z mode) with in-plane padding (W 30 < 32),
    mirror TTA over both axes, a padded tail batch, fp32."""
    jm = JaxMLLAUper(out_channels=3, **TINY)
    params = random_jax_params(jm, jnp.zeros((1, 32, 32, 1)), seed=1)
    tm = load_jax_params(MLLAUper(1, 3, **TINY), params)
    data = np.random.RandomState(0).rand(1, 2, 40, 30).astype(np.float32)
    ref = jsw.VolumePredictor(jm.apply, params, (32, 32), 3, (0, 1),
                              tile_batch_size=3)(data)
    pred = tsw.VolumePredictor(tm, (32, 32), 3, (0, 1), tile_batch_size=3,
                               device="cpu")
    assert pred.model_batch == 12
    got = pred(data)
    assert got.shape == ref.shape == (3, 2, 40, 30)
    err = np.abs(got - ref).max()
    assert err <= 1e-4 * np.abs(ref).max() + 1e-5, err


@pytest.mark.parametrize("image,tile", [((40, 30), (32, 32)), ((320, 260), (256, 224)),
                                        ((10, 64, 70), (8, 32, 32))])
def test_tiling_helpers_match_jax(image, tile):
    np.testing.assert_array_equal(tsw.compute_gaussian(tile), jsw.compute_gaussian(tile))
    padded_t, bounds_t = tsw.pad_to_min_size(np.ones((1, *image), np.float32), tile)
    padded_j, bounds_j = jsw.pad_to_min_size(np.ones((1, *image), np.float32), tile)
    assert bounds_t == bounds_j
    np.testing.assert_array_equal(padded_t, padded_j)
    np.testing.assert_array_equal(tsw.get_tile_positions(padded_t.shape[1:], tile),
                                  jsw.get_tile_positions(padded_j.shape[1:], tile))
    assert tsw.mirror_variants((0, 1)) == jsw._mirror_variants((0, 1))
