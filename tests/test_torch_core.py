"""mdm_tpu_torch.core (decode) and sampling.text (hash embedder) against
mdm_tpu on the CPU.

The decode integrates root rotation and velocity with cumulative sums over
T frames, so f32 reordering grows with T: 40 frames of unit-scale features
are held to 1e-4. The hash embedder is pure numpy on both sides and must be
byte-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdm_tpu.core import hml_codec as jcodec  # noqa: E402
from mdm_tpu.core import quaternions as jq  # noqa: E402
from mdm_tpu.sampling import load_norm_stats as jax_norm_stats  # noqa: E402
from mdm_tpu.sampling.text import HashTextEmbedder as JaxHash  # noqa: E402
from mdm_tpu_torch.core import hml_codec, quaternions  # noqa: E402
from mdm_tpu_torch.sampling import HashTextEmbedder, load_norm_stats, make_text_embedder  # noqa: E402


def _features(seed=0, shape=(2, 40, 263)):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=shape).astype(np.float32)
    f[..., 0] *= 0.05  # root yaw velocity (rad/frame) of a plausible size
    return f


def test_quaternion_ops_match_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(4, 7, 4)).astype(np.float32)
    v = rng.normal(size=(4, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(quaternions.qinv(torch.from_numpy(q)).numpy(),
                                  np.asarray(jq.qinv(jnp.asarray(q))))
    np.testing.assert_allclose(quaternions.qrot(torch.from_numpy(q), torch.from_numpy(v)).numpy(),
                               np.asarray(jq.qrot(jnp.asarray(q), jnp.asarray(v))), atol=1e-5)


def test_recover_root_rot_pos_matches_jax():
    f = _features()
    ours = hml_codec.recover_root_rot_pos(torch.from_numpy(f))
    ref = jcodec.recover_root_rot_pos(jnp.asarray(f))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("joints", [22, 21])
def test_recover_from_ric_matches_jax(joints):
    f = _features(2, (2, 40, hml_codec.feature_dim(joints)))
    ours = hml_codec.recover_from_ric(torch.from_numpy(f), joints)
    ref = np.asarray(jcodec.recover_from_ric(jnp.asarray(f), joints))
    assert ours.shape == (2, 40, joints, 3)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=1e-5)
    assert hml_codec.feature_dim(joints) == jcodec.feature_dim(joints)


def test_hash_embedder_byte_equal():
    prompts = ["a person walks forward", "A PERSON, jumps!", "", "wave  both hands 3 times"]
    ours = HashTextEmbedder()(prompts)["text_embed"]
    ref = JaxHash()(prompts)["text_embed"]
    assert ours.dtype == np.float32 and ours.tobytes() == ref.tobytes()
    assert isinstance(make_text_embedder("hash"), HashTextEmbedder)
    # No CLIP assets in the repository: None, as mdm_tpu's make_text_embedder.
    assert make_text_embedder("clip") is None


def test_norm_stats_equal():
    for ds in ("humanml", "kit"):
        for a, b in zip(load_norm_stats(ds), jax_norm_stats(ds)):
            assert a.dtype == np.float32 and np.array_equal(a, b)
