"""lft_tpu's `--dtype mixed` under the LFT_MM_HP_SITES site subsets S1 and S2
for tests/test_torch_sites.py, made in processes of their own:

    python tests/_torch_sites_ref.py OUT.npz PART

As tests/_torch_mixed_none_ref.py (tests/_torch_bf16_ref.py says why):
lft_tpu's fused Pallas kernels in interpret mode on the CPU with XLA's
excess precision off; two pixel groups of K1 / K4 and one view of K2 / K3 a
grid step, and the forward plan set in the environment of the process
(lft_tpu reads it as it traces). PART is one of PARTS:

* `blocks_s1`, `blocks_s2`: K1's and K2's forwards under the plan, with the
  residuals (out, m, l, attn; out, tok, ml, attn) and without (out), at C
  in C_BLOCKS; `blocks_s1` also jax.vjp of each fused block under S1 with
  the backward plan `all`, `blocks_s2` the f32 forwards and VJPs;
* `fwd_s1`, `fwd_s2`: the whole fused forward under `--dtype mixed` on 2 of
  the 4 AltFilter blocks (`fwd_s1` also the f32 one), as
  tests/_torch_fwdforms_ref.py takes it;
* `step_s1`, `step_f32`: one fused Adam step of the whole model from a warm
  Adam state under the smooth loss, as tests/_torch_mixed_none_ref.py takes
  it: `--dtype mixed` under S1 (the backward's default plan, `none`), and
  `float32`.

The inputs are made here and in the test by the same functions, from seeds.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_bf16_ref import ANG_PREFIX, SPA_PREFIX  # noqa: E402
from _torch_fwdforms_ref import FWD, FWD_LAYERS, fwd_inputs  # noqa: E402
from _torch_mixed_none_ref import (C_BLOCKS, K1_SHAPE, K2_SHAPE, STEP,  # noqa: E402,F401
                                   block_inputs, smooth_loss, step_inputs, warm_state)

# S1 keeps these sites f32 and rounds the rest; S2 is its complement, so
# between them every `_sites` kernel's products are split both ways.
SUBSETS = {"s1": "qk,score,ffn,aqkv,aav,wo", "s2": "tok,v,av,lin,ascore,awo,affn"}
PARTS = ("blocks_s1", "blocks_s2", "fwd_s1", "fwd_s2", "step_s1", "step_f32")
# tests/test_torch_ang_sites_bf16.py's, not in PARTS: `k1_s1`, `k1_s2`, K1's
# forward under the plan with the residuals and its f32 one (`k1`)


def k1(res: dict) -> None:
    import jax.numpy as jnp
    from lft_tpu.kernels import ang_block as j_ang
    from lft_tpu.ops.posenc import angular_position

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    for C in C_BLOCKS:
        d = block_inputs(C)
        p = {k: jnp.asarray(v) for k, v in d["params"].items()}
        wq, wk, wv = jnp.split(p[ANG_PREFIX + "attention.in_proj_weight"], 3, axis=0)
        ln = jnp.stack([p[ANG_PREFIX + n] for n in (
            "norm.weight", "norm.bias", "feed_forward.0.weight", "feed_forward.0.bias")])
        wa = (ln, wq.T, wk.T, wv.T, p[ANG_PREFIX + "attention.out_proj.weight"].T,
              p[ANG_PREFIX + "feed_forward.1.weight"].T, p[ANG_PREFIX + "feed_forward.4.weight"].T)
        x1, pe = jnp.asarray(d["k1_x"]), jnp.asarray(angular_position(K1_SHAPE[1], C))
        for dt, mm in (("mixed", True), ("f32", False)):
            for n, a in zip(("out", "m", "l", "attn"),
                            j_ang._core_fwd(x1, pe, *wa, 8, with_res=True, mm_half=mm)):
                res[f"k1_{C}_{dt}_{n}"] = f32(a)


def blocks(res: dict, plan: str) -> None:
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
        wq, wk, wv = jnp.split(p[ANG_PREFIX + "attention.in_proj_weight"], 3, axis=0)
        ln = jnp.stack([p[ANG_PREFIX + n] for n in (
            "norm.weight", "norm.bias", "feed_forward.0.weight", "feed_forward.0.bias")])
        wa = (ln, wq.T, wk.T, wv.T, p[ANG_PREFIX + "attention.out_proj.weight"].T,
              p[ANG_PREFIX + "feed_forward.1.weight"].T, p[ANG_PREFIX + "feed_forward.4.weight"].T)
        x1, pe = jnp.asarray(d["k1_x"]), jnp.asarray(angular_position(K1_SHAPE[1], C))
        pe_tok = unfold3x3_linear(jnp.asarray(spatial_position(h, w, C))[None],
                                  p[SPA_PREFIX + "MLP.weight"])[0]
        x2, ws = jnp.asarray(d["k2_x"]), j_spa._prep(p, SPA_PREFIX)
        for dt, mm in (("mixed", True),) + ((("f32", False),) if plan == "s2" else ()):
            for n, a in zip(("out", "m", "l", "attn"),
                            j_ang._core_fwd(x1, pe, *wa, 8, with_res=True, mm_half=mm)):
                res[f"k1_{C}_{dt}_{n}"] = f32(a)
            res[f"k1_{C}_{dt}_fwd"] = f32(j_ang._core_fwd(x1, pe, *wa, 8, mm_half=mm))
            for n, a in zip(("out", "tok", "ml", "attn"),
                            j_spa._fwd_call(x2, pe_tok, *ws, 8, 5, with_res=True, mm_half=mm)):
                res[f"k2_{C}_{dt}_{n}"] = f32(a)
            res[f"k2_{C}_{dt}_fwd"] = f32(j_spa._fwd_call(x2, pe_tok, *ws, 8, 5, mm_half=mm))
        # the VJPs under the backward plan `all` (read as the backward runs):
        # S1's, and the f32 ones beside S2's forwards
        for dt, mm in (("mixed", True),) if plan == "s1" else (("f32", False),):
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


def fwd(res: dict, with_f32: bool) -> None:
    import jax.numpy as jnp
    from lft_tpu.config import Args as JArgs
    from lft_tpu.models import lft as j_lft

    j_lft.LAYER_NUM = FWD_LAYERS
    lr, p = fwd_inputs()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for dt in ("mixed", "float32")[:2 if with_f32 else 1]:
        args = JArgs(model_name="LFT", dtype=dt, **FWD)
        res[f"fwd_{dt}"] = np.asarray(
            j_lft.forward(jp, jnp.asarray(lr), args, remat=False, fused=True)).astype(np.float32)


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
    what, plan = part.split("_")
    if what == "blocks":
        blocks(res, plan)
    elif what == "k1":
        k1(res)
    elif what == "fwd":
        fwd(res, with_f32=plan == "s1")
    else:
        step(res, "mixed" if plan == "s1" else "float32")
    np.savez(out_path, **res)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_allow_excess_precision=false")
    part = sys.argv[2]
    os.environ.update(LFT_ANGB_GPS="2", LFT_ANGB_BWD_GPS="2", LFT_SPAB_VPS="1",
                      LFT_SPAB_BWD_VPS="1",
                      LFT_MM_HP_SITES=SUBSETS.get(part.split("_")[1], "all"))
    if part.startswith("fwd"):   # as tests/_torch_fwdforms_ref.py: one pixel group a step
        os.environ["LFT_ANGB_GPS"] = "1"
    os.environ.pop("LFT_MM_HP_BWD_SITES", None)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(out_path=sys.argv[1], part=part)
