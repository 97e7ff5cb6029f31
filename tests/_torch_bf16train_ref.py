"""lft_tpu's `--dtype bfloat16` training outputs for
tests/test_torch_bf16train.py, made in a process of their own:

    python tests/_torch_bf16train_ref.py OUT.npz

As tests/_torch_bf16_ref.py (its docstring says why): lft_tpu's fused Pallas
kernels in interpret mode on the CPU with XLA's excess precision off, one
pixel group of K1 / K4 and one view of K2 / K3 a grid step. For each block,
in bf16 and in f32 on the same bf16-valued inputs: the residual forms
(`_vjp_fwd`: K1 res's out, m, l, attn; K2 res's out, tok, ml, attn) and
the backwards from them (`_vjp_bwd`: K4's and K3's gradients of the input,
the LayerNorm affines, the weights and, for K3, pe_tok). Then the whole
model's gradient (`jax.grad` of the smooth loss through `forward(fused=True,
remat=False)`) under bfloat16 and float32. The inputs are made here and in
the test by the same functions, from seeds.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_bf16_ref as R  # noqa: E402

C_BLOCKS = R.C_BLOCKS
K1_SHAPE, K2_SHAPE = R.K1_SHAPE, R.K2_SHAPE
FWD, FWD_LR = R.FWD, R.FWD_LR
FWD_HR = (1, 1, 80, 80)
ANG_PREFIX, SPA_PREFIX = R.ANG_PREFIX, R.SPA_PREFIX
K1_RES = ("out", "m", "l", "attn")
K4_GRADS = ("dx", "dpe", "dln", "dwq", "dwk", "dwv", "dwo", "dw1", "dw2")
K2_RES = ("out", "tok", "ml", "attn")
K3_GRADS = ("dx", "dpe", "dln", "dwu", "dwqk", "dwv", "dwo", "dw1", "dw2", "dwlin")


def couts(C: int) -> dict:
    """The blocks' output cotangents at width C: bf16 values in [-1, 1)."""
    rng = np.random.RandomState(200 + C)
    return dict(k1=R.bf16_values(rng.rand(*K1_SHAPE, C) * 2 - 1),
                k2=R.bf16_values(rng.rand(*K2_SHAPE, C) * 2 - 1))


def train_inputs():
    """The model step's LR mosaic, HR target and parameters (bf16 values)."""
    lr, p = R.fwd_inputs()
    hr = np.random.RandomState(8).rand(*FWD_HR).astype(np.float32)
    return lr, hr, p


def smooth_loss(sr, hr, xp):
    """A loss without L1's sign flips at residuals within rounding of 0 (a
    flip moves a gradient by a whole step; tests/test_torch_mixed.py)."""
    return xp.mean((sr - hr) * xp.cos(3.0 * (sr - hr)))


def main(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from lft_tpu.config import Args as JArgs
    from lft_tpu.kernels import ang_block as j_ang
    from lft_tpu.kernels import spa_block as j_spa
    from lft_tpu.kernels.spa_attn_hp import pick_hp_geometry
    from lft_tpu.models import lft as j_lft
    from lft_tpu.ops.posenc import angular_position, spatial_position
    from lft_tpu.ops.unfold import unfold3x3_linear

    res = {}
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    h, w = K2_SHAPE[1:]
    res["k2_tile"] = np.asarray(pick_hp_geometry(h, w, 8, 5)[:2])
    for C in C_BLOCKS:
        d, co = R.inputs(C), couts(C)
        for dt in ("bf16", "f32"):
            t = jnp.bfloat16 if dt == "bf16" else jnp.float32
            p = {k: jnp.asarray(v).astype(t) for k, v in d["params"].items()}
            # K1 res and K4
            ipw = p[ANG_PREFIX + "attention.in_proj_weight"]
            wq, wk, wv = jnp.split(ipw, 3, axis=0)
            ln = jnp.stack([p[ANG_PREFIX + n] for n in (
                "norm.weight", "norm.bias", "feed_forward.0.weight", "feed_forward.0.bias")])
            wts = (ln, wq.T, wk.T, wv.T, p[ANG_PREFIX + "attention.out_proj.weight"].T,
                   p[ANG_PREFIX + "feed_forward.1.weight"].T,
                   p[ANG_PREFIX + "feed_forward.4.weight"].T)
            x = jnp.asarray(d["k1_x"]).astype(t)
            pe = jnp.asarray(angular_position(K1_SHAPE[1], C))
            out, r1 = j_ang._vjp_fwd(x, pe, *wts, 8, False)
            for n, a in zip(K1_RES, (out, *r1[-3:])):
                res[f"k1_{C}_{dt}_{n}"] = f32(a)
            for n, a in zip(K4_GRADS, j_ang._vjp_bwd(8, False, r1, jnp.asarray(co["k1"])
                                                     .astype(t))):
                res[f"k4_{C}_{dt}_{n}"] = f32(a)
            # K2 res and K3
            pe_tok = unfold3x3_linear(jnp.asarray(spatial_position(h, w, C))[None].astype(t),
                                      p[SPA_PREFIX + "MLP.weight"])[0]
            x = jnp.asarray(d["k2_x"]).astype(t)
            out, r2 = j_spa._spa_vjp_fwd(x, pe_tok, *j_spa._prep(p, SPA_PREFIX), 8, 5, False)
            res[f"k2_{C}_{dt}_petok"] = f32(pe_tok)
            for n, a in zip(K2_RES, (out, *r2[-3:])):
                res[f"k2_{C}_{dt}_{n}"] = f32(a)
            for n, a in zip(K3_GRADS, j_spa._spa_vjp_bwd(8, 5, False, r2, jnp.asarray(co["k2"])
                                                         .astype(t))):
                res[f"k3_{C}_{dt}_{n}"] = f32(a)
    lr, hr, p = train_inputs()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    keys = sorted(jp)
    for dt in ("bfloat16", "float32"):
        args = JArgs(model_name="LFT", dtype=dt, **FWD)
        loss = lambda p_: smooth_loss(j_lft.forward(p_, jnp.asarray(lr), args, remat=False,
                                                    fused=True), jnp.asarray(hr), jnp)
        val, g = jax.jit(jax.value_and_grad(loss))(jp)
        res[f"grad_{dt}"] = np.concatenate([np.asarray(g[k]).ravel() for k in keys])
        res[f"loss_{dt}"] = np.asarray(val)
    np.savez(out_path, **res)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_allow_excess_precision=false")
    os.environ.update(LFT_ANGB_GPS="1", LFT_ANGB_BWD_GPS="1", LFT_SPAB_VPS="1",
                      LFT_SPAB_BWD_VPS="1")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(sys.argv[1])
