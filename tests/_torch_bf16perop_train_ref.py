"""lft_tpu's `--dtype bfloat16` training through its unfused branch, for
tests/test_torch_bf16perop_train.py, made in a process of its own:

    python tests/_torch_bf16perop_train_ref.py OUT.npz PART

PART is one of PARTS: a share of the kernels, or a share of the train steps
(the test starts them together). As tests/_torch_bf16perop_ref.py (its
docstring says why): lft_tpu's per-op Pallas kernels in interpret mode on
the CPU with XLA's excess precision off, one view (K5) and one pixel group
(K7) a grid step.

For each kernel, in bf16 and in f32 on the same bf16-valued inputs: its
custom VJP's forward with residuals (`_vjp_fwd`: out, m, l, the stats taken
to the port's layout, [B, h, w, H] or [N, A2, H]) and its backward from
them (`_vjp_bwd`: dq, dk, dv) for a bf16-valued cotangent; and whether
lft_tpu's hybrid pairs K5's kernels for training (`_use_headpacked_pair`)
at a few geometries. For each train step, the whole model's gradient
(`jax.grad` of the smooth loss through `forward(fused=False, remat=False)`)
under bfloat16 and float32. The inputs are made here and in the test by the
same functions, from seeds.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_bf16_ref import bf16_values, np_params  # noqa: E402
from _torch_bf16train_ref import smooth_loss  # noqa: E402

H = 8
# kernel -> (its family, the shape of its q, k, v): C = 16 and C = 64 models
# (the window kernels take E = 2C, the angular ones C)
KERNELS = {
    "k5_16": ("k5", (2, 8, 8, 32)), "k5_64": ("k5", (1, 8, 8, 128)),
    "k6_16": ("k6", (2, 16, 16, 32)), "k6_64": ("k6", (1, 8, 16, 128)),
    "k7_16": ("k7", (16, 25, 16)), "k7_64": ("k7", (8, 25, 64)),
    "k8_16": ("k8", (16, 25, 16)), "k8_64": ("k8", (8, 25, 64)),
    "k8_144": ("k8", (4, 144, 16)),
    "k9_16": ("k9", (2, 7, 9, 32)), "k9_64": ("k9", (1, 7, 9, 128)),
}
# views the hybrid is asked to pair for training, [1, h, w, E]
PAIRS = ((8, 8, 32), (16, 16, 32), (32, 32, 128), (64, 64, 128), (48, 48, 32), (96, 96, 32),
         (128, 128, 128))
# train step -> (angRes, LR mosaic edge, channels, LFT_SPA_VARIANT, LFT_ANG_VARIANT, impls)
STEPS = {
    "s5": (5, 40, 16, None, None, ("pallas", "auto")),        # 8x8 views: K7 + K5, or XLA ops
    "s12": (12, 48, 16, None, None, ("pallas", "auto")),      # 4x4 views, A2 = 144: K8 + K5
    "s5_mxu": (5, 40, 16, "mxu", None, ("pallas",)),          # K7 + K6
    "s5_sweep": (5, 40, 16, "offset", "sweep", ("pallas",)),  # K8 (A2 = 25) + K9
}
PARTS = {"kernels_a": ("k5_16", "k5_64", "k6_16", "k6_64", "k9_16", "k9_64"),
         "kernels_b": ("k7_16", "k7_64", "k8_16", "k8_64", "k8_144"),
         "steps_a": ("s5", "s5_mxu"), "steps_b": ("s12", "s5_sweep")}


def kernel_inputs(name: str):
    """q, k, v and the output's cotangent, bf16 values: q and k spread so
    that the softmax is not flat."""
    rng = np.random.RandomState(sum(map(ord, name)) + 7)
    shape = KERNELS[name][1]
    return tuple(bf16_values(rng.randn(*shape) * s) for s in (1.5, 1.5, 1.0, 1.0))


def step_inputs(name: str):
    """A step's LR mosaic [1, 1, E, E], HR target [1, 1, 2E, 2E] and its
    model's parameters (bf16 values)."""
    ang_res, edge, C, _, _, _ = STEPS[name]
    rng = np.random.RandomState(edge + 3 * ang_res)
    lr = rng.rand(1, 1, edge, edge).astype(np.float32)
    hr = rng.rand(1, 1, 2 * edge, 2 * edge).astype(np.float32)
    return lr, hr, np_params(C, 2, 9)


def _window_stats(m, B, h, w, th, tw):
    """lft_tpu's per-tile stats [B, tiles, th tw, H] -> [B, h, w, H]."""
    m = np.asarray(m, np.float32).reshape(B, h // th, w // tw, th, tw, H)
    return m.transpose(0, 1, 3, 2, 4, 5).reshape(B, h, w, H)


def port_stats(family: str, m, shape):
    """lft_tpu's (m or l) of a kernel's `_vjp_fwd` in the port's layout."""
    from lft_tpu.kernels.spa_attn import pick_tile
    from lft_tpu.kernels.spa_attn_hp import pick_hp_geometry
    m = np.asarray(m, np.float32)
    if family in ("k5", "k6"):
        B, h, w, _ = shape
        th, tw = (pick_hp_geometry(h, w, H, 5)[:2] if family == "k5" else pick_tile(h, w))
        return _window_stats(m, B, h, w, th, tw)
    if family == "k9":
        return m.reshape(*shape[:3], H)
    N, A2, _ = shape
    if family == "k7":
        return m.reshape(-1, A2, H)[:N]
    chunk = 32                       # lft_tpu/kernels/ang_attn_vjp.py:_CHUNK
    return m.reshape(-1, A2, chunk, H).transpose(0, 2, 1, 3).reshape(-1, A2, H)[:N]


def main(out_path: str, part: str) -> None:
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from lft_tpu.config import Args as JArgs
    from lft_tpu.kernels import ang_attn_mxu, ang_attn_vjp, local_attn_vjp, spa_attn, spa_attn_hp
    from lft_tpu.models import lft as j_lft

    res = {}
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    if part.startswith("steps"):
        for name in PARTS[part]:
            ang_res, _, C, spa, ang, impls = STEPS[name]
            lr, hr, p = step_inputs(name)
            jp = {key: jnp.asarray(a) for key, a in p.items()}
            keys = sorted(jp)
            for knob, val in (("LFT_SPA_VARIANT", spa), ("LFT_ANG_VARIANT", ang)):
                if val:
                    os.environ[knob] = val
            for impl in impls:
                for dt in ("bfloat16", "float32"):
                    args = JArgs(model_name="LFT", dtype=dt, angRes=ang_res, scale_factor=2,
                                 channels=C)
                    loss = lambda p_, a_=args, i_=impl: smooth_loss(
                        j_lft.forward(p_, jnp.asarray(lr), a_, attention_impl=i_, remat=False,
                                      fused=False), jnp.asarray(hr), jnp)
                    val, g = jax.jit(jax.value_and_grad(loss))(jp)
                    res[f"{name}_{impl}_{dt}_grad"] = np.concatenate(
                        [np.asarray(g[k]).ravel() for k in keys])
                    res[f"{name}_{impl}_{dt}_loss"] = np.asarray(val)
            os.environ.pop("LFT_SPA_VARIANT", None)
            os.environ.pop("LFT_ANG_VARIANT", None)
        np.savez(out_path, **res)
        return

    mods = {"k5": (spa_attn_hp, (H, 5)), "k6": (spa_attn, (H, 5)), "k7": (ang_attn_mxu, (H,)),
            "k8": (ang_attn_vjp, (H,)), "k9": (local_attn_vjp, (H, 5))}
    for name in PARTS[part]:
        family, shape = KERNELS[name]
        mod, cfg = mods[family]
        q, k, v, dout = kernel_inputs(name)
        for dt, t in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
            qkv = [jnp.asarray(a).astype(t) for a in (q, k, v)]
            out, r = mod._vjp_fwd(*qkv, *cfg)
            assert out.dtype == t, (name, out.dtype)
            m, l = r[-2:]
            res[f"{name}_{dt}_out"] = f32(out)
            res[f"{name}_{dt}_m"] = port_stats(family, m, shape)
            res[f"{name}_{dt}_l"] = port_stats(family, l, shape)
            grads = mod._vjp_bwd(*cfg, r, jnp.asarray(dout).astype(t))
            for g_name, g in zip(("dq", "dk", "dv"), grads):
                assert g.dtype == t, (name, g_name, g.dtype)
                res[f"{name}_{dt}_{g_name}"] = f32(g)
    if part == "kernels_a":
        for h, w, E in PAIRS:
            x = jnp.zeros((1, h, w, E), jnp.bfloat16)
            res[f"pair_{h}x{w}x{E}"] = np.asarray(spa_attn._use_headpacked_pair(x, H, 5))
    np.savez(out_path, **res)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_allow_excess_precision=false")
    os.environ.update(LFT_HP_VPS="1", LFT_ANG_GPS="1")
    os.environ.pop("LFT_ANG_VARIANT", None)
    os.environ.pop("LFT_SPA_VARIANT", None)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(*sys.argv[1:3])
