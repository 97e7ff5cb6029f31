"""lft_tpu's `--dtype mixed` training under LFT_MM_HP_SITES=none for
tests/test_torch_mixed_none_train.py, made in processes of their own:

    python tests/_torch_mixed_none_ref.py OUT.npz PART

As tests/_torch_fwdforms_ref.py (tests/_torch_bf16_ref.py says why):
lft_tpu's fused Pallas kernels in interpret mode on the CPU with XLA's
excess precision off; two pixel groups of K1 / K4 and one view of K2 / K3 a
grid step. PART is one of PARTS:

* `blocks`: K1's and K2's `with_res` forwards with `mm_half` (out, m, l,
  attn; out, tok, ml, attn) beside their f32 forms, at C in C_BLOCKS; and
  jax.vjp of each fused block under the forward plan `none` and the
  backward plan `all` (LFT_MM_HP_BWD_SITES=all), beside the f32 VJP;
* `step_none`, `step_f32`: one fused Adam step of the whole model (all 4
  AltFilter blocks) from a warm Adam state under the smooth loss, as
  tests/test_torch_mixed.py's `test_mixed_fused_train_step_matches_jax`
  takes it: `--dtype mixed` under the plan `none` (the backward's default
  plan, `none`), and `float32`; the update and the loss, and (`step_none`)
  the warm state's leaves;
* `k1` (tests/test_torch_ang_bf16.py, not in PARTS): `blocks`' K1 forwards
  alone (out, m, l, attn under `none` and in f32).

The inputs are made here and in the test by the same functions, from seeds.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_bf16_ref import ANG_PREFIX, SPA_PREFIX  # noqa: E402
from _torch_fwdforms_ref import f32_params  # noqa: E402

PARTS = ("blocks", "step_none", "step_f32")
C_BLOCKS = (16, 64)
K1_SHAPE = (13, 25)          # N pixels, A2 views
K2_SHAPE = (3, 8, 8)         # V views of h x w
STEP = dict(angRes=5, scale_factor=2, channels=16, batch_size=1, lr=2e-4, n_steps=15,
            gamma=0.5, epoch=2, train_fused="true")
STEP_LR, STEP_HR = (1, 1, 40, 40), (1, 1, 80, 80)


def block_inputs(C: int) -> dict:
    """The blocks' inputs at width C (f32 values that are not bf16 values),
    their output cotangents and the parameters."""
    rng = np.random.RandomState(500 + C)
    f = lambda *s: (rng.rand(*s) * 2 - 1).astype(np.float32)
    return dict(k1_x=f(*K1_SHAPE, C), k2_x=f(*K2_SHAPE, C), k1_dout=f(*K1_SHAPE, C),
                k2_dout=f(*K2_SHAPE, C), params=f32_params(C, 2, 600 + C))


def step_inputs():
    """The step's LR mosaic, HR target and parameters."""
    rng = np.random.RandomState(24)
    lr = ((rng.rand(*STEP_LR) - 0.5) * 0.5 + 0.5).astype(np.float32)
    hr = ((rng.rand(*STEP_HR) - 0.5) * 0.5 + 0.5).astype(np.float32)
    return lr, hr, f32_params(STEP["channels"], STEP["scale_factor"], 23)


def smooth_loss(sr, hr, xp):
    """A loss without L1's sign flips at residuals within rounding of 0."""
    return xp.mean((sr - hr) * xp.cos(3.0 * (sr - hr)))


def warm_state(flat: dict, n_params: int) -> dict:
    """A warm Adam state from a fresh one's leaves: 5 steps taken, second
    moments of 1e-6 (from zero moments the first update is lr g / (|g| +
    eps), f32 noise and all)."""
    flat = dict(flat)
    for i, key in enumerate(sorted(flat)):
        if flat[key].ndim == 0:
            flat[key] = np.asarray(5, flat[key].dtype)
        elif i > n_params:
            flat[key] = np.full_like(flat[key], 1e-6)
    return flat


def blocks(res: dict, k1_only: bool = False) -> None:
    import jax
    import jax.numpy as jnp
    from lft_tpu.kernels import ang_block as j_ang
    from lft_tpu.kernels import spa_block as j_spa
    from lft_tpu.kernels.spa_attn_hp import pick_hp_geometry
    from lft_tpu.ops.posenc import angular_position, spatial_position
    from lft_tpu.ops.unfold import unfold3x3_linear

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    h, w = K2_SHAPE[1:]
    res["k2_tile"] = np.asarray(pick_hp_geometry(h, w, 8, 5)[:2])
    for C in C_BLOCKS:
        d = block_inputs(C)
        p = {k: jnp.asarray(v) for k, v in d["params"].items()}
        ipw = p[ANG_PREFIX + "attention.in_proj_weight"]
        wq, wk, wv = jnp.split(ipw, 3, axis=0)
        ln = jnp.stack([p[ANG_PREFIX + n] for n in (
            "norm.weight", "norm.bias", "feed_forward.0.weight", "feed_forward.0.bias")])
        wa = (ln, wq.T, wk.T, wv.T, p[ANG_PREFIX + "attention.out_proj.weight"].T,
              p[ANG_PREFIX + "feed_forward.1.weight"].T, p[ANG_PREFIX + "feed_forward.4.weight"].T)
        x1, pe = jnp.asarray(d["k1_x"]), jnp.asarray(angular_position(K1_SHAPE[1], C))
        pe_tok = unfold3x3_linear(jnp.asarray(spatial_position(h, w, C))[None],
                                  p[SPA_PREFIX + "MLP.weight"])[0]
        x2, ws = jnp.asarray(d["k2_x"]), j_spa._prep(p, SPA_PREFIX)
        for dt, mm in (("none", True), ("f32", False)):
            for n, a in zip(("out", "m", "l", "attn"),
                            j_ang._core_fwd(x1, pe, *wa, 8, with_res=True, mm_half=mm)):
                res[f"k1_{C}_{dt}_{n}"] = f32(a)
            if k1_only:
                continue
            for n, a in zip(("out", "tok", "ml", "attn"),
                            j_spa._fwd_call(x2, pe_tok, *ws, 8, 5, with_res=True, mm_half=mm)):
                res[f"k2_{C}_{dt}_{n}"] = f32(a)
            # the VJPs under the backward plan `all` (read as the backward runs)
            os.environ["LFT_MM_HP_BWD_SITES"] = "all"
            try:
                _, vjp = jax.vjp(lambda x_, *w_: j_ang.ang_block_core(x_, pe, *w_, 8, mm),
                                 x1, *wa)
                for i, g in enumerate(vjp(jnp.asarray(d["k1_dout"]))):
                    res[f"k4_{C}_{dt}_{i}"] = f32(g)
                _, vjp = jax.vjp(lambda x_, pe_, *w_: j_spa.spa_block_core(x_, pe_, *w_, 8, 5, mm),
                                 x2, pe_tok, *ws)
                for i, g in enumerate(vjp(jnp.asarray(d["k2_dout"]))):
                    res[f"k3_{C}_{dt}_{i}"] = f32(g)
            finally:
                os.environ.pop("LFT_MM_HP_BWD_SITES")
        res[f"k2_{C}_petok"] = f32(pe_tok)


def step(res: dict, dtype: str) -> None:
    import dataclasses

    import jax.numpy as jnp
    from lft_tpu.config import Args as JArgs
    from lft_tpu.registry import get_model as j_get_model
    from lft_tpu.training import optim as j_optim
    from lft_tpu.training import trainer as j_trainer

    lr, hr, np_p = step_inputs()
    jargs = JArgs(model_name="LFT", train_remat=False, dtype=dtype, **STEP)
    tx = j_optim.make_optimizer(jargs, steps_per_epoch=10)
    jp = {k: jnp.asarray(v) for k, v in np_p.items()}
    flat = warm_state(j_trainer.flatten_opt_state(tx.init(jp)), len(np_p))
    model = dataclasses.replace(j_get_model(jargs),
                                loss=lambda sr, y: smooth_loss(sr, y, jnp))
    fn = j_trainer.make_train_step(model, tx, jargs, with_metrics=False)
    jp2, _, aux = fn(jp, j_trainer.unflatten_opt_state(tx.init(jp), flat), jnp.asarray(lr),
                     jnp.asarray(hr))
    keys = sorted(np_p)
    res["update"] = np.concatenate([(np.asarray(jp2[k]) - np_p[k]).ravel() for k in keys])
    res["loss"] = np.asarray(float(aux["loss"]))
    if dtype == "mixed":
        res.update({f"flat_{k}": v for k, v in flat.items()})


def main(out_path: str, part: str) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    res = {}
    if part in ("blocks", "k1"):
        blocks(res, part == "k1")
    else:
        step(res, "mixed" if part == "step_none" else "float32")
    np.savez(out_path, **res)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_allow_excess_precision=false")
    os.environ.update(LFT_ANGB_GPS="2", LFT_ANGB_BWD_GPS="2", LFT_SPAB_VPS="1",
                      LFT_SPAB_BWD_VPS="1", LFT_MM_HP_SITES="none")
    os.environ.pop("LFT_MM_HP_BWD_SITES", None)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(*sys.argv[1:3])
