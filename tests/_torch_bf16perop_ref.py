"""lft_tpu's `--dtype bfloat16` unfused branch, for tests/test_torch_bf16perop.py,
made in a process of its own:

    python tests/_torch_bf16perop_ref.py OUT.npz PART

PART is one of PARTS: the kernels and ops, or a share of the forwards (the
test starts the three together; lft_tpu's interpret-mode kernels take most
of the time, tracing each block's kernels).

lft_tpu's per-op Pallas kernels (K5-K10) run in interpret mode on the CPU,
as its own tests run them, and its XLA ops (the op-by-op LayerNorm, the
attentions of `lft_tpu/ops/attention.py`, the tokenization conv) run on
the CPU, all with XLA's excess precision off (`--xla_allow_excess_precision
=false`, read when XLA starts, hence the process: with it on, the CPU keeps
some bf16 intermediates in f32; tests/_torch_bf16_ref.py says more). Each
function runs on the same bf16-valued inputs in bf16 and in f32: the f32
output is the yardstick of the bf16 one's distance.

The inputs are made here and in the test by the same functions, from seeds.
lft_tpu's per-op kernels run one view (K5, `LFT_HP_VPS=1`) and one pixel
group (K7, `LFT_ANG_GPS=1`) a grid step: the same values, a shorter trace.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_bf16_ref import bf16_values, np_params  # noqa: E402

H = 8
# kernel -> the shape of its q, k, v
KERNELS = {
    "k5_32": (2, 8, 8, 32), "k5_128": (1, 8, 8, 128),
    "k6": (2, 16, 16, 32),
    "k7_16": (16, 25, 16), "k7_64": (8, 25, 64),
    "k8_25": (16, 25, 16), "k8_144": (4, 144, 16),
    "k9": (2, 7, 9, 32),
    "k10": (2, 16, 16, 32),
}
# forward -> (angRes, LR mosaic edge, channels, LFT_SPA_VARIANT, attention_impls)
FORWARDS = {
    "fwd5": (5, 40, 16, None, ("pallas", "auto")),      # 8x8 views: K7 + K5, or XLA ops
    "fwd12": (12, 48, 16, None, ("pallas", "auto")),    # 4x4 views, A2 = 144: K8 + K5
    "fwd7": (5, 35, 16, None, ("pallas", "auto")),      # 7x7 views, no tile: K7 + K9, or dense
    "fwd_mxu": (5, 40, 16, "mxu", ("pallas",)),         # K7 + K6
    "fwd_tile": (5, 40, 16, "tile", ("pallas",)),       # K7 + K10
    "fwd_c48": (5, 40, 48, None, ("auto",)),            # a width the card's kernels do not take
}
PARTS = {"kernels": (), "fwd_a": ("fwd5", "fwd12", "fwd_mxu", "fwd_c48"),
         "fwd_b": ("fwd7", "fwd_tile")}


def kernel_inputs(name: str):
    """q, k, v of bf16 values: q and k spread so that the softmax is not flat."""
    rng = np.random.RandomState(sum(map(ord, name)))
    shape = KERNELS[name]
    return tuple(bf16_values(rng.randn(*shape) * s) for s in (1.5, 1.5, 1.0))


def op_inputs():
    """The ops' inputs, bf16 values: LN x [64, 32] with its affine; the
    angular MHA's tokens [16, 25, 16] and weights; the window attentions'
    token images [2, 16, 16, 32] (tiled) and [2, 7, 9, 32] (dense) and
    weights; the tokenization conv's image [3, 8, 8, 16] and MLP weight."""
    rng = np.random.RandomState(11)
    u = lambda *s: bf16_values((rng.rand(*s) - 0.5) * 2 / np.sqrt(s[-1]))
    return dict(
        ln_x=bf16_values(rng.randn(64, 32) * 2 + 0.5),
        ln_w=bf16_values(1 + 0.2 * rng.randn(32)), ln_b=bf16_values(0.2 * rng.randn(32)),
        mha_qn=bf16_values(rng.randn(16, 25, 16)), mha_v=bf16_values(rng.randn(16, 25, 16)),
        mha_win=u(48, 16) * 4, mha_wout=u(16, 16),
        tiled_qn=bf16_values(rng.randn(2, 16, 16, 32)), tiled_v=bf16_values(rng.randn(2, 16, 16, 32)),
        dense_qn=bf16_values(rng.randn(2, 7, 9, 32)), dense_v=bf16_values(rng.randn(2, 7, 9, 32)),
        win_in=u(96, 32) * 4, win_out=u(32, 32),
        unfold_x=bf16_values(rng.randn(3, 8, 8, 16)), unfold_w=u(32, 144),
    )


def fwd_inputs(name: str):
    """A forward's LR mosaic [1, 1, E, E] and its model's parameters."""
    ang_res, edge, C, _, _ = FORWARDS[name]
    lr = np.random.RandomState(edge + ang_res).rand(1, 1, edge, edge).astype(np.float32)
    return lr, np_params(C, 2, 5)


def main(out_path: str, part: str) -> None:
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from lft_tpu.config import Args as JArgs
    from lft_tpu.kernels import ang_attn_mxu, ang_attn_vjp, local_attn, local_attn_vjp
    from lft_tpu.kernels import spa_attn, spa_attn_hp
    from lft_tpu.models import lft as j_lft
    from lft_tpu.ops import attention as j_att
    from lft_tpu.ops.unfold import unfold3x3_linear

    res = {}
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    for name in PARTS[part]:
        ang_res, _, C, variant, impls = FORWARDS[name]
        lr, p = fwd_inputs(name)
        jp = {key: jnp.asarray(a) for key, a in p.items()}
        if variant:
            os.environ["LFT_SPA_VARIANT"] = variant
        for impl in impls:
            for dt in ("bfloat16", "float32"):
                args = JArgs(model_name="LFT", dtype=dt, angRes=ang_res, scale_factor=2,
                             channels=C)
                fwd = jax.jit(lambda p_, x_: j_lft.forward(p_, x_, args, attention_impl=impl,
                                                           remat=False, fused=False))
                res[f"{name}_{impl}_{dt}"] = f32(fwd(jp, jnp.asarray(lr)))
        os.environ.pop("LFT_SPA_VARIANT", None)
    if part != "kernels":
        np.savez(out_path, **res)
        return
    kfns = {
        "k5": lambda q, k, v: spa_attn_hp.windowed_attention_headpacked(q, k, v, H, 5),
        "k6": lambda q, k, v: spa_attn.windowed_attention_mxu(q, k, v, H, 5),
        "k7": lambda q, k, v: ang_attn_mxu.ang_attention_blockdiag(q, k, v, H),
        "k8": lambda q, k, v: ang_attn_vjp.ang_attention(q, k, v, H),
        "k9": lambda q, k, v: local_attn_vjp.windowed_attention(q, k, v, H, 5),
        "k10": lambda q, k, v: local_attn._windowed_attention_pallas(q, k, v, H, 5, 8),
    }
    for name in KERNELS:
        q, k, v = kernel_inputs(name)
        for dt, t in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
            out = kfns[name.split("_")[0]](*(jnp.asarray(a).astype(t) for a in (q, k, v)))
            assert out.dtype == t, (name, out.dtype)
            res[f"{name}_{dt}"] = f32(out)

    d = op_inputs()
    for dt, t in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        c = {key: jnp.asarray(a).astype(t) for key, a in d.items()}
        outs = dict(
            ln=j_lft._layer_norm(c["ln_x"], c["ln_w"], c["ln_b"]),
            mha=j_att.multi_head_attention(c["mha_qn"], c["mha_qn"], c["mha_v"], c["mha_win"],
                                           c["mha_wout"], H),
            tiled=j_att.local_attention_tiled(c["tiled_qn"], c["tiled_v"], c["win_in"],
                                              c["win_out"], H, 5, 8),
            dense=j_att.local_attention(c["dense_qn"], c["dense_v"], c["win_in"], c["win_out"],
                                        H, 5, impl="dense"),
            unfold=unfold3x3_linear(c["unfold_x"], c["unfold_w"]))
        for op, out in outs.items():
            res[f"{op}_{dt}"] = f32(out)
            res[f"{op}_{dt}_dtype"] = np.array(str(out.dtype))
    np.savez(out_path, **res)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_allow_excess_precision=false")
    os.environ.update(LFT_HP_VPS="1", LFT_ANG_GPS="1")
    os.environ.pop("LFT_ANG_VARIANT", None)
    os.environ.pop("LFT_SPA_VARIANT", None)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(*sys.argv[1:3])
