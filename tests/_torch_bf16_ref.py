"""lft_tpu's `--dtype bfloat16` outputs for tests/test_torch_bf16.py, made in
a process of their own:

    python tests/_torch_bf16_ref.py OUT.npz [k1 | k2]

lft_tpu's fused Pallas kernels run in interpret mode on the CPU, as its own
tests run them, with XLA's excess precision off
(`--xla_allow_excess_precision=false`). With it on (XLA's default), the CPU
interpret mode keeps some of the kernels' bf16 intermediates in f32: one
K1 block then lies 0.93 of the way from its written rounding points to f32,
where the kernel body run op by op on plain arrays, and the interpret mode
with the flag off, round every one (bitwise equal to each other). A Mosaic
kernel on the TPU rounds where the code says, so the flag off is the
kernel. The flag is read when XLA starts, hence the process of its own.
Each grid step takes one pixel group of K1 and one view of K2
(`LFT_ANGB_GPS=1`, `LFT_SPAB_VPS=1`): the same values, a shorter trace.

The inputs are made here and in the test by the same functions, from seeds.
With `k1` only K1's blocks are made (`k1_{C}_bf16`, `k1_{C}_f32`), with
`k2` only K2's (and their `_petok`).
"""

import os
import sys

import numpy as np

C_BLOCKS = (16, 64)
K1_SHAPE = (64, 25)          # N pixels, A2 views
K2_SHAPE = (3, 8, 8)         # V views of h x w
FWD = dict(angRes=5, scale_factor=2, channels=16)
FWD_LR = (1, 1, 40, 40)      # 8x8 views
ANG_PREFIX = "altblock.1.ang_trans."
SPA_PREFIX = "altblock.2.spa_trans."


def bf16_values(a: np.ndarray) -> np.ndarray:
    """f32 array of `a` rounded to the nearest bf16 (ties to even)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def np_params(channels: int, scale: int, seed: int) -> dict:
    """Model parameters of bf16 values (the LayerNorm affine away from 1, 0
    so that a rounding there shows)."""
    from lft_torch.models.lft import param_shapes
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in sorted(param_shapes(channels, scale).items()):
        if len(s) == 1:
            v = 1.0 + 0.2 * rng.randn(*s)
        else:
            v = (rng.rand(*s) - 0.5) * 2 / np.sqrt(np.prod(s[1:]))
        out[k] = bf16_values(v)
    return out


def inputs(C: int) -> dict:
    """The blocks' inputs at width C: K1's x [N, A2, C], K2's x [V, h, w, C]
    (bf16 values in [-1, 1)) and the parameters."""
    rng = np.random.RandomState(100 + C)
    return dict(k1_x=bf16_values(rng.rand(*K1_SHAPE, C) * 2 - 1),
                k2_x=bf16_values(rng.rand(*K2_SHAPE, C) * 2 - 1),
                params=np_params(C, 2, C))


def fwd_inputs():
    """The forward's LR mosaic and parameters."""
    lr = np.random.RandomState(7).rand(*FWD_LR).astype(np.float32)
    return lr, np_params(FWD["channels"], FWD["scale_factor"], 5)


def main(out_path: str, part: str = "all") -> None:
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from lft_tpu.config import Args as JArgs
    from lft_tpu.kernels import ang_block as j_ang
    from lft_tpu.kernels import spa_block as j_spa
    from lft_tpu.models import lft as j_lft
    from lft_tpu.ops.posenc import angular_position, spatial_position
    from lft_tpu.ops.unfold import unfold3x3_linear

    res = {}
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    for C in C_BLOCKS:
        d = inputs(C)
        for dt in ("bf16", "f32"):
            t = jnp.bfloat16 if dt == "bf16" else jnp.float32
            p = {k: jnp.asarray(v).astype(t) for k, v in d["params"].items()}
            if part != "k2":
                res[f"k1_{C}_{dt}"] = f32(j_ang.ang_trans_block_fused(
                    jnp.asarray(d["k1_x"]).astype(t),
                    jnp.asarray(angular_position(K1_SHAPE[1], C)), p, ANG_PREFIX, 8))
            if part == "k1":
                continue
            h, w = K2_SHAPE[1:]
            pe_tok = unfold3x3_linear(jnp.asarray(spatial_position(h, w, C))[None].astype(t),
                                      p[SPA_PREFIX + "MLP.weight"])[0]
            res[f"k2_{C}_{dt}_petok"] = f32(pe_tok)
            res[f"k2_{C}_{dt}"] = f32(j_spa.spa_trans_block_fused(
                jnp.asarray(d["k2_x"]).astype(t), pe_tok, p, SPA_PREFIX, 8, 5))
    lr, p = fwd_inputs()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for dt in (("bfloat16", "float32") if part == "all" else ()):
        args = JArgs(model_name="LFT", dtype=dt, **FWD)
        fwd = jax.jit(lambda p_, x_: j_lft.forward(p_, x_, args, remat=False, fused=True))
        res[f"fwd_{dt}"] = f32(fwd(jp, jnp.asarray(lr)))
    np.savez(out_path, **res)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_allow_excess_precision=false")
    os.environ.update(LFT_ANGB_GPS="1", LFT_SPAB_VPS="1")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(*sys.argv[1:3])
