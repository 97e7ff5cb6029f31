"""lft_tpu's outputs for tests/test_torch_fwdforms.py, made in a process of
their own:

    python tests/_torch_fwdforms_ref.py OUT.npz [PART ...]

(PART: `k11` or `fwd`; both where none is named.)

K11 (`spa_trans_block_fused(pixel_major=True)`) on a bf16 pixel-major
buffer and, under LFT_MM_HP_SITES=none, on an f32 one with `mm_half`; each
beside its f32 form on the same values. Then the whole fused forward under
`--dtype mixed` with LFT_MM_HP_SITES=none beside the f32 one, on 2 of the 4
AltFilter blocks (a short interpret-mode trace). lft_tpu's Pallas kernels
run in interpret mode on the CPU with XLA's excess precision off, as
tests/_torch_bf16_ref.py runs them (its docstring says why); one view a
grid step (`LFT_SPAB_VPS=1`, `LFT_ANGB_GPS=1`).

The inputs are made here and in the test by the same functions, from seeds.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_bf16_ref import SPA_PREFIX, bf16_values, np_params  # noqa: E402

C_BLOCKS = (16, 64)
K11_SHAPE = (2, 8, 8, 25)    # Bb, h, w, A2
FWD = dict(angRes=5, scale_factor=2, channels=16)
FWD_LR = (1, 1, 40, 40)      # 8x8 views
FWD_LAYERS = 2               # AltFilter blocks of the forward


def f32_params(channels: int, scale: int, seed: int) -> dict:
    """Model parameters of f32 values that are not bf16 values (so that a
    product site's rounding of the weights shows), the LayerNorm affine away
    from 1, 0."""
    from lft_torch.models.lft import param_shapes
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in sorted(param_shapes(channels, scale).items()):
        if len(s) == 1:
            out[k] = (1.0 + 0.2 * rng.randn(*s)).astype(np.float32)
        else:
            out[k] = ((rng.rand(*s) - 0.5) * 2 / np.sqrt(np.prod(s[1:]))).astype(np.float32)
    return out


def k11_inputs(C: int) -> dict:
    """K11's pixel-major buffers at width C: bf16 values in [-1, 1) for the
    bf16 case (with `np_params`' bf16 parameters), f32 ones for the mixed
    case (with `f32_params`)."""
    rng = np.random.RandomState(200 + C)
    return dict(x_bf16=bf16_values(rng.rand(*K11_SHAPE, C) * 2 - 1),
                x_f32=(rng.rand(*K11_SHAPE, C) * 2 - 1).astype(np.float32),
                params_bf16=np_params(C, 2, 300 + C), params_f32=f32_params(C, 2, 400 + C))


def fwd_inputs():
    """The forward's LR mosaic and f32 parameters."""
    lr = np.random.RandomState(9).rand(*FWD_LR).astype(np.float32)
    return lr, f32_params(FWD["channels"], FWD["scale_factor"], 11)


def main(out_path: str, parts=("k11", "fwd")) -> None:
    """`parts`: "k11" (both K11 cases) and "fwd" (the forwards); all by
    default."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from lft_tpu.config import Args as JArgs
    from lft_tpu.kernels import spa_block as j_spa
    from lft_tpu.models import lft as j_lft
    from lft_tpu.ops.posenc import spatial_position
    from lft_tpu.ops.unfold import unfold3x3_linear

    res = {}
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    h, w = K11_SHAPE[1:3]
    for C in C_BLOCKS if "k11" in parts else ():
        d = k11_inputs(C)
        for case, dts in (("bf16", (jnp.bfloat16, jnp.float32)), ("f32", (jnp.float32,))):
            for dt in dts:
                p = {k: jnp.asarray(v).astype(dt) for k, v in d[f"params_{case}"].items()}
                pe_tok = unfold3x3_linear(jnp.asarray(spatial_position(h, w, C))[None].astype(dt),
                                          p[SPA_PREFIX + "MLP.weight"])[0]
                x = jnp.asarray(d[f"x_{case}"]).astype(dt)
                run = lambda mm: f32(j_spa.spa_trans_block_fused(
                    x, pe_tok, p, SPA_PREFIX, 8, 5, pixel_major=True, mm_half=mm))
                if case == "bf16":
                    key = f"k11_{C}_{'bf16' if dt == jnp.bfloat16 else 'f32'}"
                    res[key] = run(False)
                    res[key + "_petok"] = f32(pe_tok)
                else:
                    res[f"k11m_{C}_petok"] = f32(pe_tok)
                    res[f"k11m_{C}_mixed"], res[f"k11m_{C}_f32"] = run(True), run(False)
    j_lft.LAYER_NUM = FWD_LAYERS
    lr, p = fwd_inputs()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for dt in ("mixed", "float32") if "fwd" in parts else ():
        args = JArgs(model_name="LFT", dtype=dt, **FWD)
        res[f"fwd_{dt}"] = f32(j_lft.forward(jp, jnp.asarray(lr), args, remat=False, fused=True))
    np.savez(out_path, **res)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_allow_excess_precision=false")
    os.environ.update(LFT_ANGB_GPS="1", LFT_SPAB_VPS="1", LFT_MM_HP_SITES="none")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(sys.argv[1], tuple(sys.argv[2:]) or ("k11", "fwd"))
