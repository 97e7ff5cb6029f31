"""lft_tpu's `--dtype mixed` training under LFT_MM_HP_BWD_SITES site subsets
for tests/test_torch_bwd_sites.py, made in processes of their own:

    python tests/_torch_bwd_sites_ref.py OUT.npz PART

As tests/_torch_sites_ref.py (tests/_torch_bf16_ref.py says why): lft_tpu's
fused Pallas kernels in interpret mode on the CPU with XLA's excess
precision off; two pixel groups of K1 / K4 and one view of K2 / K3 a grid
step. lft_tpu reads the forward plan (LFT_MM_HP_SITES) as its forward traces
and the backward plan (LFT_MM_HP_BWD_SITES) as its backward does: both are
set in the environment around each call. The backward plans are
tests/_torch_sites_ref.py's complementary subsets S1 and S2 (`SUBSETS`),
between which every `_sites` launch of the backward is split both ways.
PART is one of PARTS:

* `k4a25_{C}`, `k4a81_{C}`, `k3_{C}` (C in C_BLOCKS): jax.vjp of the fused
  AngTrans block at A2 = 25 (K1_SHAPE) or 81 (K1_SHAPE_81), or of the fused
  SpaTrans block (K2_SHAPE), with mm_half under each (forward, backward)
  pair of FWD_PLANS x SUBSETS, and the f32 VJP;
* `step_none_s1`, `step_s2_s2`, `step_f32`: one fused Adam step of the
  whole model from a warm Adam state under the smooth loss, as
  tests/_torch_mixed_none_ref.py takes it: `--dtype mixed` under (forward
  `none`, backward S1) and (forward S2, backward S2), and `float32`.

The inputs are made here and in the test by the same functions, from seeds.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_bf16_ref import ANG_PREFIX, SPA_PREFIX  # noqa: E402
from _torch_mixed_none_ref import (K1_SHAPE, K2_SHAPE, STEP, block_inputs,  # noqa: E402,F401
                                   smooth_loss, step_inputs, warm_state)
from _torch_sites_ref import SUBSETS  # noqa: E402

C_BLOCKS = (16, 32)
K1_SHAPE_81 = (5, 81)         # N pixels, A2 views past 64
FWD_PLANS = {"all": "all", "s1": SUBSETS["s1"]}
STEPS = {"none_s1": ("none", SUBSETS["s1"]), "s2_s2": (SUBSETS["s2"], SUBSETS["s2"])}
PARTS = tuple(f"{k}_{C}" for C in C_BLOCKS for k in ("k4a25", "k4a81", "k3")) + tuple(
    f"step_{s}" for s in (*STEPS, "f32"))


def k4_inputs(C: int, A2: int) -> dict:
    """K4's block input and cotangent at A2 views (block_inputs' at 25)."""
    d = block_inputs(C)
    if A2 == K1_SHAPE[1]:
        return dict(x=d["k1_x"], dout=d["k1_dout"], params=d["params"])
    rng = np.random.RandomState(700 + C)
    f = lambda *s: (rng.rand(*s) * 2 - 1).astype(np.float32)
    return dict(x=f(*K1_SHAPE_81, C), dout=f(*K1_SHAPE_81, C), params=d["params"])


def _env(fwd: str, bwd: str):
    os.environ["LFT_MM_HP_SITES"] = fwd
    os.environ["LFT_MM_HP_BWD_SITES"] = bwd


def blocks(res: dict, kind: str, C: int) -> None:
    import jax
    import jax.numpy as jnp
    from lft_tpu.kernels import ang_block as j_ang
    from lft_tpu.kernels import spa_block as j_spa
    from lft_tpu.ops.posenc import angular_position, spatial_position
    from lft_tpu.ops.unfold import unfold3x3_linear

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    if kind == "k3":
        d = block_inputs(C)
        p = {k: jnp.asarray(v) for k, v in d["params"].items()}
        h, w = K2_SHAPE[1:]
        pe_tok = unfold3x3_linear(jnp.asarray(spatial_position(h, w, C))[None],
                                  p[SPA_PREFIX + "MLP.weight"])[0]
        x, ws, dout = jnp.asarray(d["k2_x"]), j_spa._prep(p, SPA_PREFIX), d["k2_dout"]
        res["petok"] = f32(pe_tok)
        run = lambda mm: jax.vjp(lambda x_, pe_, *w_: j_spa.spa_block_core(x_, pe_, *w_, 8, 5, mm),
                                 x, pe_tok, *ws)
    else:
        A2 = int(kind[len("k4a"):])
        d = k4_inputs(C, A2)
        p = {k: jnp.asarray(v) for k, v in d["params"].items()}
        wq, wk, wv = jnp.split(p[ANG_PREFIX + "attention.in_proj_weight"], 3, axis=0)
        ln = jnp.stack([p[ANG_PREFIX + n] for n in (
            "norm.weight", "norm.bias", "feed_forward.0.weight", "feed_forward.0.bias")])
        wa = (ln, wq.T, wk.T, wv.T, p[ANG_PREFIX + "attention.out_proj.weight"].T,
              p[ANG_PREFIX + "feed_forward.1.weight"].T, p[ANG_PREFIX + "feed_forward.4.weight"].T)
        x, pe, dout = jnp.asarray(d["x"]), jnp.asarray(angular_position(A2, C)), d["dout"]
        run = lambda mm: jax.vjp(lambda x_, *w_: j_ang.ang_block_core(x_, pe, *w_, 8, mm), x, *wa)
    cases = [(f"{f}_{b}", FWD_PLANS[f], SUBSETS[b], True) for f in FWD_PLANS for b in SUBSETS]
    for name, fwd, bwd, mm in cases + [("f32", "all", "all", False)]:
        _env(fwd, bwd)
        _, vjp = run(mm)
        for i, g in enumerate(vjp(jnp.asarray(dout))):
            res[f"{name}_{i}"] = f32(g)


def step(res: dict, part: str) -> None:
    import dataclasses

    import jax.numpy as jnp
    from lft_tpu.config import Args as JArgs
    from lft_tpu.registry import get_model as j_get_model
    from lft_tpu.training import optim as j_optim
    from lft_tpu.training import trainer as j_trainer

    dtype = "float32" if part == "f32" else "mixed"
    _env(*STEPS.get(part, ("all", "all")))
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
    res.update({f"flat_{k}": v for k, v in flat.items()})


def main(out_path: str, part: str) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    res = {}
    what, rest = part.split("_", 1)
    if what == "step":
        step(res, rest)
    else:
        blocks(res, what, int(rest))
    np.savez(out_path, **res)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_allow_excess_precision=false")
    os.environ.update(LFT_ANGB_GPS="2", LFT_ANGB_BWD_GPS="2", LFT_SPAB_VPS="1",
                      LFT_SPAB_BWD_VPS="1")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(*sys.argv[1:3])
