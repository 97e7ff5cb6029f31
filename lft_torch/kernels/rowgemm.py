"""The weight streams of the 3xTF32 row-tile products (`lft_torch/csrc/
rowgemm.cuh`) in plain PyTorch, and the geometry their kernels are built
with.

K2.2 (`spa_block.qkv`), K2.4 (`spa_block.outproj_ln`), K2.5 / K11.5
(`spa_block.ffn_out`), K3.a (`spa_block.ffn_out_bwd`), K3.d
(`spa_block.qkv_ln_bwd`), K1 (`ang_block.ang_block`) and K4's steps a and
c (`ang_block.ang_block_bwd_ops`) run their products as
`acc[64 x N] += A[64 x K] B` on the tensor cores: A a warpgroup's token rows
in shared memory, B a weight matrix split into TF32 hi and lo and laid out
in K-major core matrices, streamed through a ring of `RG_SF`-float stages
(K2.2's, K2.4's, K3.d's and K4 c's W x W pieces stay resident instead). The first kernel of each launch
(`rg_weights_kernel`) writes a kernel's weights as one stream of such
pieces, in the order its products read them, into a scratch buffer the
wrapper allocates. `piece` and the `*_stream` functions are that
preparation in plain PyTorch, which the CPU tests emulate the kernels from;
`*_floats` are the scratch sizes and `*_smem` the shared memory the kernels
take (`RowProj`, `FfnOut`, `FfnOutBwd`, `AngLayout`, `AngBwdTok`,
`QkvLnBwd` in the sources). K2.5's `_bf16` instance (`csrc/ffn_bf16.cuh`)
runs bf16 `wgmma` on its three weights held whole in shared memory:
`bf16_piece` and `ffn_out_bf16_stream` are its weights' layout,
`ffn_out_bf16_floats` and `ffn_out_bf16_smem` its sizes (`FfnBf16`).
K2.5's `_sites` instances (`csrc/ffn_sites.cuh`) take the rounded weights
in `bf16_piece`'s layout and the f32 ones split, Wlin's rows in
`sites_rows` order where its product's A comes from an accumulator
(`sites_piece`):
`ffn_out_sites_stream`, `ffn_out_sites_floats` and `ffn_out_sites_smem`
(`FfnSites`). K2.5's `_bf16io` instances run the `_bf16` kernel on bf16 rows
(`ffn_out_bf16io_smem`). K1's all-bf16 forms (`csrc/ang_bf16.cuh`) hold
their six weights rounded to bf16 in `bf16_piece`'s layout
(`ang_bf16_stream`, `ang_bf16_floats`, `ang_bf16_smem`: `AngBf16`); K1's
`_sites` forms (`csrc/ang_sites.cuh`) hold the weights of the sites that
round likewise and stream the others split, their layout and shared memory
placed from the mask (`ang_sites_plan`, `ang_sites_stream`,
`ang_sites_floats`: `AngSites`, `AngSitesPlan`). A backward's transposed
weights are split straight from the forward's (`RgPiece::tr`): no
transposed copy is made.
"""

from __future__ import annotations

import torch

from lft_torch.kernels.common import SITE_BITS

RG_M = 128             # token rows of a block: 2 warpgroups of 64
RG_SF = 4096           # floats of a weight-ring stage (16 KB)
RG_SMEM_MAX = 232448   # shared memory a block can use on an H100


def tf32_rn(a: torch.Tensor) -> torch.Tensor:
    """a rounded to TF32 as `cvt.rna.tf32.f32` rounds: to nearest, ties away
    from zero (add 0x1000 to the bits, clear the low 13)."""
    return ((a.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(a: torch.Tensor):
    """(hi, lo), a = hi + lo up to 2^-21 |a|: hi = tf32_rn(a), lo = a - hi
    truncated to TF32 (what an MMA reads of it): the tokenization's split
    (tf32.cuh:split_tf32)."""
    hi = tf32_rn(a)
    return hi, ((a - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32_rn(a: torch.Tensor):
    """(hi, lo), a = hi + lo up to 2^-23 |a|: both rounded to nearest, the
    row-tile products' split (tf32.cuh:split_tf32_rn)."""
    hi = tf32_rn(a)
    return hi, tf32_rn(a - hi)


def piece(B: torch.Tensor, split=split_tf32_rn) -> torch.Tensor:
    """One K x N weight matrix as the kernels read it, flat: split into TF32
    hi/lo (`split_tf32_rn`; the tokenization's `split_tf32`) and laid out
    [K / 8, 2, 2, N / 8, 8, 4]: (k8 step kk, hi or lo, k half kh, n8 tile j,
    row n, t) holds B[8 kk + 4 kh + t][8 j + n], so a k8 step's hi (or lo)
    is core matrices of 8 columns x 4 k (128 bytes each), N / 8 of them
    along N, then the second k half: the K-major operand `wgmma` reads
    without swizzle."""
    K, N = B.shape
    hi, lo = split(B)
    f = torch.stack([hi, lo]).reshape(2, K // 8, 2, 4, N // 8, 8)
    return f.permute(1, 0, 2, 4, 5, 3).reshape(-1)


def bf16_piece(B: torch.Tensor) -> torch.Tensor:
    """One K x N weight matrix as K2.5's bf16 kernel reads it (`csrc/
    ffn_bf16.cuh`), flat: rounded to bf16 (to nearest even) and laid out
    [K / 16, 2, N / 8, 8, 8]: (k16 step kk, k half kh, n8 tile j, row n, t)
    holds B[16 kk + 8 kh + t][8 j + n], the K-major core matrices (8
    columns x 8 k, 128 bytes each) bf16 `wgmma` reads without swizzle."""
    K, N = B.shape
    f = B.to(torch.bfloat16).reshape(K // 16, 2, 8, N // 8, 8)
    return f.permute(0, 1, 3, 4, 2).reshape(-1)


def hidden_chunk(width: int) -> int:
    """Columns of the FFN's hidden layer a kernel computes at a time
    (hidden width 2 x `width`): at most 64."""
    return min(64, 2 * width)


def ffn_out_pieces(w1, w2, wlin):
    """K2.5's weights in stream order: per hidden chunk W1[:, chunk] and
    W2[chunk, :], then Wlin."""
    D = w1.shape[0]
    hc = hidden_chunk(D)
    out = []
    for j in range(0, 2 * D, hc):
        out += [w1[:, j:j + hc], w2[j:j + hc]]
    return out + [wlin]


def ang_block_pieces(wts: dict):
    """K1's weights in stream order: Wv, Wq, Wk, Wo, then per hidden chunk
    W1[:, chunk] and W2[chunk, :]."""
    C = wts["wq"].shape[0]
    hc = hidden_chunk(C)
    out = [wts["wv"], wts["wq"], wts["wk"], wts["wo"]]
    for j in range(0, 2 * C, hc):
        out += [wts["w1"][:, j:j + hc], wts["w2"][j:j + hc]]
    return out


def ffn_out_bwd_layout(C: int):
    """K3.a's stream (FfnOutBwd<C> in spa_block_bwd.cu): [(name, chunk,
    K, N, offset)] in the order its products read them, and the stream's
    floats. Wo; per hidden chunk W1[:, c], W2[c, :]; Wlinᵀ; per chunk
    W2ᵀ[:, c], W1ᵀ[c, :]; Woᵀ. A piece starts at a multiple of its 16-of-K
    chain (32 N floats): the second loop at a multiple of 32 max(D, HC),
    which leaves a gap after Wlinᵀ at C = 16."""
    D = 2 * C
    hc = hidden_chunk(D)
    nh = 2 * D // hc
    sq, w1, w2 = 2 * D * D, 2 * D * hc, 2 * hc * D
    align = 32 * max(D, hc)
    out = [("wo", None, D, D, 0)]
    for j in range(nh):
        off = sq + j * (w1 + w2)
        out += [("w1", j, D, hc, off), ("w2", j, hc, D, off + w1)]
    off_lin = sq + nh * (w1 + w2)
    out.append(("wlinT", None, C, D, off_lin))
    off_b = -(-(off_lin + 2 * C * D) // align) * align
    for j in range(nh):
        off = off_b + j * (w1 + w2)
        out += [("w2T", j, D, hc, off), ("w1T", j, hc, D, off + w2)]
    off_ot = off_b + nh * (w1 + w2)
    out.append(("woT", None, D, D, off_ot))
    return out, off_ot + sq


def ffn_out_bwd_pieces(wts: dict):
    """K3.a's weights in stream order (`ffn_out_bwd_layout`), as K x N
    matrices."""
    D = wts["wo"].shape[0]
    hc = hidden_chunk(D)
    mats = dict(wo=wts["wo"], w1=wts["w1"], w2=wts["w2"], wlinT=wts["wlin"].t(),
                w2T=wts["w2"].t(), w1T=wts["w1"].t(), woT=wts["wo"].t())
    cut = dict(w1=lambda m, j: m[:, j * hc:(j + 1) * hc], w2T=lambda m, j: m[:, j * hc:(j + 1) * hc],
               w2=lambda m, j: m[j * hc:(j + 1) * hc], w1T=lambda m, j: m[j * hc:(j + 1) * hc])
    layout, _ = ffn_out_bwd_layout(D // 2)
    return [mats[n] if j is None else cut[n](mats[n], j) for n, j, _, _, _ in layout]


def ffn_out_bwd_stream(wts: dict) -> torch.Tensor:
    """Plain version of the K3.a launches' weight preparation (zero in the
    gap the kernel never reads)."""
    layout, floats = ffn_out_bwd_layout(wts["wo"].shape[0] // 2)
    out = torch.zeros(floats, dtype=wts["wo"].dtype)
    for (_, _, K, N, off), m in zip(layout, ffn_out_bwd_pieces(wts)):
        out[off:off + 2 * K * N] = piece(m.contiguous())
    return out


def ang_bwd_tok_layout(C: int):
    """K4 step a's stream (AngBwdTok<C> in ang_block.cu): [(name, chunk, K,
    N, offset)] in the order its products read them, and the stream's
    floats. Wv, Wq, Wk, Wo; per hidden chunk W1[:, c], W2ᵀ[:, c], W1ᵀ[c, :];
    Woᵀ. No gaps: every piece starts at a multiple of its 16-of-K chain."""
    hc = hidden_chunk(C)
    sq, pc = 2 * C * C, 2 * C * hc
    out = [(n, None, C, C, i * sq) for i, n in enumerate(("wv", "wq", "wk", "wo"))]
    for j in range(2 * C // hc):
        off = 4 * sq + 3 * j * pc
        out += [("w1", j, C, hc, off), ("w2T", j, C, hc, off + pc), ("w1T", j, hc, C, off + 2 * pc)]
    off_ot = 4 * sq + 3 * (2 * C // hc) * pc
    out.append(("woT", None, C, C, off_ot))
    return out, off_ot + sq


def ang_bwd_tok_pieces(wts: dict):
    """K4 step a's weights in stream order (`ang_bwd_tok_layout`), as K x N
    matrices (views of the forward's weights)."""
    C = wts["wq"].shape[0]
    hc = hidden_chunk(C)
    mats = dict(wv=wts["wv"], wq=wts["wq"], wk=wts["wk"], wo=wts["wo"], w1=wts["w1"],
                w2T=wts["w2"].t(), w1T=wts["w1"].t(), woT=wts["wo"].t())
    cut = dict(w1=lambda m, j: m[:, j * hc:(j + 1) * hc], w2T=lambda m, j: m[:, j * hc:(j + 1) * hc],
               w1T=lambda m, j: m[j * hc:(j + 1) * hc])
    layout, _ = ang_bwd_tok_layout(C)
    return [mats[n] if j is None else cut[n](mats[n], j) for n, j, _, _, _ in layout]


def ang_bwd_tok_stream(wts: dict) -> torch.Tensor:
    """Plain version of K4 step a's weight preparation."""
    return torch.cat([piece(p) for p in ang_bwd_tok_pieces(wts)])


def qkv_ln_bwd_stream(wq, wk, wv) -> torch.Tensor:
    """Plain version of the weight preparation of K3.d and K4's step c: Wqᵀ,
    Wkᵀ, Wvᵀ from the forward's W x W weights."""
    return torch.cat([piece(w.t()) for w in (wq, wk, wv)])


def qkv_pieces(wqk, wv):
    """K2.2's weights in stream order: Wq, Wk (the halves of wqk [D, 2D]),
    Wv."""
    D = wv.shape[0]
    return [wqk[:, :D], wqk[:, D:], wv]


def qkv_stream(wts: dict) -> torch.Tensor:
    """Plain version of the K2.2 launches' weight preparation."""
    return torch.cat([piece(p) for p in qkv_pieces(wts["wqk"], wts["wv"])])


def outproj_stream(wts: dict) -> torch.Tensor:
    """Plain version of the K2.4 launches' weight preparation: Wo."""
    return piece(wts["wo"])


def ffn_out_stream(wts: dict) -> torch.Tensor:
    """Plain version of the K2.5 / K11.5 launches' weight preparation."""
    return torch.cat([piece(p) for p in ffn_out_pieces(wts["w1"], wts["w2"], wts["wlin"])])


SITES_CHAIN = 4        # 16s of K a chain of K2.5 `_sites`'s 3xTF32 products (FS_CHAIN)


def sites_rows(K: int) -> list:
    """The rows of a K-row weight in the order `csrc/ffn_sites.cuh` lays them
    out for a product whose A fragments come from an accumulator
    (`ffn_sites_k`): in each group of 8, logical row k is row 2 (k % 4) + k
    // 4, since the TF32 fragment's k = q, q + 4 hold the accumulator's
    columns 2 q, 2 q + 1."""
    return [8 * (k // 8) + 2 * (k % 4) + k % 8 // 4 for k in range(K)]


def sites_piece(B: torch.Tensor) -> torch.Tensor:
    """`piece` of B with its rows in `sites_rows` order."""
    return piece(B[sites_rows(B.shape[0])])


def ffn_out_sites_stream(wts: dict, ffn: bool):
    """Plain version of the `spa_ffn_out_sites` launches' weight preparation
    (`ffn_sites_weights_kernel`), as (bf16 values, f32 values) in scratch
    order. ffn (the `ffn` site rounds, `lin` does not): W1 and W2 whole,
    each a `bf16_piece`, then Wlin split (`sites_piece`); else, per hidden
    chunk, W1[:, chunk] and W2[chunk, :] split (`piece`), then Wlin a
    `bf16_piece`."""
    if ffn:
        return (torch.cat([bf16_piece(wts["w1"]), bf16_piece(wts["w2"])]),
                sites_piece(wts["wlin"]))
    D = wts["w1"].shape[0]
    hc = hidden_chunk(D)
    parts = []
    for j in range(0, 2 * D, hc):
        parts += [piece(wts["w1"][:, j:j + hc]), piece(wts["w2"][j:j + hc])]
    return bf16_piece(wts["wlin"]), torch.cat(parts)


def ffn_out_bf16_stream(wts: dict) -> torch.Tensor:
    """Plain version of the `spa_ffn_out_bf16` launches' weight preparation
    (`ffn_bf16_weights_kernel`): W1, W2 and Wlin whole, each a `bf16_piece`,
    bf16 values."""
    return torch.cat([bf16_piece(wts[n]) for n in ("w1", "w2", "wlin")])


def ang_block_stream(wts: dict) -> torch.Tensor:
    """Plain version of the K1 launches' weight preparation."""
    return torch.cat([piece(p) for p in ang_block_pieces(wts)])


ANG_BF16_ORDER = ("wv", "wq", "wk", "wo", "w1", "w2")


def ang_bf16_stream(wts: dict) -> torch.Tensor:
    """Plain version of the weight preparation of K1's all-bf16 forms
    (`ang_block[_res]_bf16io`, `ang_block[_res]_bf16`: `csrc/ang_bf16.cuh`,
    `ang_bf16_weights_kernel`): Wv, Wq, Wk, Wo, W1 and W2 whole, each a
    `bf16_piece`, bf16 values."""
    return torch.cat([bf16_piece(wts[n].float()) for n in ANG_BF16_ORDER])


# K1's weights in the order of `ang_sites.cuh` (bf16 offsets and stream
# pieces alike) and the site of each
ANG_SITES_ORDER = (("wv", "aqkv"), ("wq", "aqkv"), ("wk", "aqkv"), ("wo", "awo"),
                   ("w1", "affn"), ("w2", "affn"))


def ang_sites_plan(C: int, mask: int) -> dict:
    """The layout of a K1 `_sites` launch under `mask` (common.site_mask's
    bits), as `ang_sites.cuh:ang_sites_plan` computes it: `bw` the bf16
    offsets of Wv, Wq, Wk, Wo, W1, W2 where their site rounds (compacted, -1
    where f32); `sw` the stream offsets (floats, each a multiple of 32
    max(C, hc)) of Wv, Wq, Wk, Wo and the FFN's first hidden chunk where f32
    (-1 where rounded), `stream` its floats; of it the groups Wv-Wk, Wo and
    the FFN held resident in that order while they fit beside the rows
    (with three ring slots left where a group still streams): `res` floats,
    the ring's part from `rb`; the byte offsets in shared memory of the
    resident split weights (`rbase`, past the bf16 ones), of the rows past
    all resident weights (`wbytes`): q, k, v (144 rows: bf16 at C + 8
    values where `ascore` / `aav` round, f32 at C + 4 floats where not), a
    hidden chunk's rows (`hid`, where `affn` is f32: over k's, and LN2(x2)'s
    rows over q's, where q and k are f32 at the chunk's row stride, `rows`;
    else over k and v, `hid_kv`), the attention
    output (`ao`: over q where its format, bf16 where `awo` rounds, is
    q's), pass 1's maxima (`mh`), the ring (`ring`, `ns` slots of 16 KB
    with two mbarriers each, up to 8, none where nothing streams) and the
    block's `bytes`."""
    sq, hc = C * C, hidden_chunk(C)
    nh = 2 * C // hc
    align = 32 * max(C, hc)
    up = lambda v, a: -(-v // a) * a
    rounds = lambda site: bool(mask & SITE_BITS[site])
    bw, b = [], 0
    for (n, site), e in zip(ANG_SITES_ORDER, (sq, sq, sq, sq, 2 * sq, 2 * sq)):
        bw.append(b if rounds(site) else -1)
        b += e if rounds(site) else 0
    sw, end, s = [], [], 0
    for i, (n, site) in enumerate(ANG_SITES_ORDER[:5]):
        if rounds(site):
            sw.append(-1)
        else:
            sw.append(up(s, align))
            s = sw[-1] + (2 * sq if i < 4 else nh * 4 * C * hc)
        end.append(s)
    rows, r16, r32 = RG_M + 16, (C + 8) * 2, (C + 4) * 4
    qb, vb, ob = rounds("ascore"), rounds("aav"), rounds("awo")
    qbytes, vbytes = rows * (r16 if qb else r32), rows * (r16 if vb else r32)
    rows_ = not rounds("affn") and not qb and C + 4 == hc + 4
    hid_kv = not rounds("affn") and not rows_
    kv = max(qbytes + vbytes, RG_M * (hc + 4) * 4 if hid_kv else 0)
    tiles = up(qbytes + kv + (RG_M * (r16 if ob else r32) if qb != ob else 0)
               + rows * (C // 16) * 4, 16)
    slot = RG_SF * 4 + 16
    p = dict(bw=bw, sw=sw, stream=s, rbase=up(2 * b, 16), res=0, hid_kv=hid_kv, rows=rows_)
    prev = 0
    for g_end in (end[2], end[3], end[4]):   # Wv-Wk, Wo, the FFN
        if g_end == prev:
            continue
        prev = g_end
        if p["rbase"] + 4 * g_end + tiles + (3 * slot if g_end < s else 0) > RG_SMEM_MAX:
            break
        p["res"] = g_end
    p["rb"] = up(p["res"], align)
    p["wbytes"] = p["rbase"] + 4 * p["res"]
    p["q"] = p["wbytes"]
    p["k"] = p["q"] + qbytes
    p["v"] = p["k"] + qbytes
    p["hid"] = p["k"]
    o = p["k"] + kv
    p["ao"] = p["q"] if qb == ob else o
    if qb != ob:
        o += RG_M * (r16 if ob else r32)
    p["mh"] = o
    p["ring"] = up(o + rows * (C // 16) * 4, 16)
    p["ns"] = 0 if s == p["res"] else min(8, (RG_SMEM_MAX - p["ring"]) // slot)
    p["bytes"] = p["ring"] + p["ns"] * slot
    return p


def ang_sites_stream(wts: dict, mask: int):
    """Plain version of the weight preparation of K1's `_sites` forms
    (`ang_sites_weights_kernel`): (the weights of the sites that round, each
    a `bf16_piece`, compacted in ANG_SITES_ORDER; the stream of the others
    split, as f32 values at `ang_sites_plan`'s offsets, zero in the gaps):
    Wv, Wq, Wk and, but where the plan's `rows` (A from LN2(x2)'s rows),
    W1[:, chunk] (A from accumulators) as `sites_piece`s, Wo and W2[chunk, :]
    as `piece`s."""
    C = wts["wq"].shape[0]
    hc = hidden_chunk(C)
    p = ang_sites_plan(C, mask)
    rounds = lambda site: bool(mask & SITE_BITS[site])
    bf = [bf16_piece(wts[n].float()) for n, site in ANG_SITES_ORDER if rounds(site)]
    out = torch.zeros(p["stream"])
    for i, (n, site) in enumerate(ANG_SITES_ORDER[:4]):
        if not rounds(site):
            f = piece(wts[n].float()) if n == "wo" else sites_piece(wts[n].float())
            out[p["sw"][i]:p["sw"][i] + f.numel()] = f
    if not rounds("affn"):
        at = p["sw"][4]
        for j in range(0, 2 * C, hc):
            w1 = wts["w1"][:, j:j + hc].float()
            for f in ((piece if p["rows"] else sites_piece)(w1),
                      piece(wts["w2"][j:j + hc].float())):
                out[at:at + f.numel()] = f
                at += f.numel()
    return (torch.cat(bf) if bf else torch.zeros(0, dtype=torch.bfloat16)), out


def outproj_floats(C: int) -> int:
    """Floats of one D x D weight split (RowProj<C>::SQ): K2.4's Wo, and
    each of K2.2's three."""
    return 2 * (2 * C) ** 2


def qkv_floats(C: int) -> int:
    """Floats of K2.2's weight stream: Wq, Wk, Wv."""
    return 3 * outproj_floats(C)


def ffn_out_floats(C: int) -> int:
    """Floats of K2.5's weight stream (FfnOut<C>::FLOATS)."""
    D = 2 * C
    return 2 * (4 * D * D + D * C)


def ffn_out_bf16_floats(C: int) -> int:
    """f32 words of `spa_ffn_out_bf16`'s scratch: its FfnBf16<C>::ELEMS =
    4 D^2 + D C bf16 values, two a word."""
    D = 2 * C
    return (4 * D * D + D * C) // 2


def ffn_out_sites_floats(C: int, ffn: bool) -> int:
    """f32 words of `spa_ffn_out_sites`'s scratch (FfnSites<C, ffn>::FLOATS),
    within `ffn_out_floats(C)`: ffn the bf16 W1, W2 (two a word) and Wlin
    split; else W1, W2 split and the bf16 Wlin."""
    D = 2 * C
    return 2 * D * D + 2 * D * C if ffn else 8 * D * D + D * C // 2


def ffn_out_bwd_floats(C: int) -> int:
    """Floats of K3.a's weight stream (FfnOutBwd<C>::FLOATS)."""
    return ffn_out_bwd_layout(C)[1]


def ang_block_floats(C: int) -> int:
    """Floats of K1's weight stream (AngLayout<C>::FLOATS)."""
    return 16 * C * C


def ang_bf16_floats(C: int) -> int:
    """f32 words of the scratch of K1's all-bf16 forms: AngBf16<C>::ELEMS =
    8 C^2 bf16 values, two a word."""
    return 4 * C * C


def ang_sites_floats(C: int) -> int:
    """f32 words of the scratch of K1's `_sites` forms (AngSites<C>::FLOATS):
    the rounded weights (at most 8 C^2 bf16 values), then the stream of the
    others split (at most 16 C^2 floats and the gaps that align its
    pieces)."""
    return 4 * C * C + 16 * C * C + 6 * 32 * max(C, hidden_chunk(C))


def ang_bwd_tok_floats(C: int) -> int:
    """Floats of K4 step a's weight stream (AngBwdTok<C>::FLOATS): 11 C x C
    weights split."""
    return ang_bwd_tok_layout(C)[1]


def qkv_ln_bwd_floats(W: int) -> int:
    """Floats of the weight stream of K3.d (W = 2C) and K4's step c (W = C),
    QkvLnBwd<W>::FLOATS: three W x W weights split."""
    return 6 * W * W


def ang_bwd_floats(C: int) -> int:
    """Floats of K4's weight scratch: step a's stream, then step c's."""
    return ang_bwd_tok_floats(C) + qkv_ln_bwd_floats(C)


def ring_slots(tile_bytes: int) -> int:
    """Weight-ring slots beside `tile_bytes` of rows (rg_slots)."""
    return min(8, (RG_SMEM_MAX - tile_bytes) // (RG_SF * 4))


def proj_smem(C: int) -> int:
    """Shared memory of a K2.2 or K2.4 block: one D x D weight split and a
    tile of rows [128, 2C + 4] (RowProj<C>::BYTES)."""
    return (outproj_floats(C) + RG_M * (2 * C + 4)) * 4


def ffn_out_smem(C: int) -> int:
    """Shared memory of a K2.5 block: xn2 / y [128, 2C + 4], a hidden chunk
    [128, 68] and the ring (FfnOut<C>::BYTES)."""
    D = 2 * C
    tiles = RG_M * (D + 4 + hidden_chunk(D) + 4) * 4
    return tiles + ring_slots(tiles) * RG_SF * 4


def ffn_out_bf16_smem(C: int) -> int:
    """Shared memory of a `spa_ffn_out_bf16` block: the bf16 weights and
    the rows of xn2 [128, 2C + 8] (FfnBf16<C>::BYTES)."""
    D = 2 * C
    return 4 * ffn_out_bf16_floats(C) + RG_M * (D + 8) * 4


def ffn_out_bf16io_smem(C: int) -> int:
    """Shared memory of a `spa_ffn_out_bf16io` block (the `_bf16` kernel with
    bf16 rows): the bf16 weights and the rows of xn2 [128, 2C + 8] in bf16
    (FfnBf16<C>::BYTES16)."""
    D = 2 * C
    return 4 * ffn_out_bf16_floats(C) + RG_M * (D + 8) * 2


def ffn_out_sites_smem(C: int, ffn: bool) -> int:
    """Shared memory of a `spa_ffn_out_sites` block (FfnSites<C, ffn>::BYTES):
    ffn the resident weights alone (bf16 W1, W2 and Wlin split); else the
    bf16 Wlin, the rows of xn2 [128, 2C + 4] and of a hidden chunk [128,
    68], and the ring's slots with two mbarriers each."""
    D = 2 * C
    if ffn:
        return 4 * ffn_out_sites_floats(C, True)
    fixed = 2 * D * C + RG_M * (D + 4 + hidden_chunk(D) + 4) * 4
    return fixed + ring_slots(fixed + 16 * 8) * (RG_SF * 4 + 16)


def ffn_out_bwd_smem(C: int) -> int:
    """Shared memory of a K3.a block: the rows [128, 2C + 4] (attn, xn2,
    dy, dx2), a hidden chunk [128, 68] (dout first), the 8 warps' LN2 sums
    [8, 2, 2C], the rows' LN2 mean and 1/std [128, 2], the threads' ReLU
    signs [chunks, 256], the ring and its two mbarriers a slot
    (FfnOutBwd<C>::BYTES)."""
    D = 2 * C
    hc = hidden_chunk(D)
    tiles = (RG_M * (D + 4 + hc + 4) + 8 * 2 * D + 2 * RG_M + 2 * D // hc * 256) * 4
    slots = ring_slots(tiles + 16 * 8)
    return tiles + slots * RG_SF * 4 + 2 * slots * 8


def ang_block_smem(C: int) -> int:
    """Shared memory of a K1 block: four [128, C + 4] tiles (x / q, xn /
    attention / LN2, k, v / a hidden chunk) and the ring
    (AngLayout<C>::BYTES)."""
    tiles = 4 * RG_M * (C + 4) * 4
    return tiles + ring_slots(tiles) * RG_SF * 4


ANG_BF16_ROWS = RG_M + 16   # q, k, v rows: a pixel's last 16 queries may pass the tile by 15


def ang_bf16_groups(C: int) -> int:
    """Head groups of the attention of K1's all-bf16 kernel (AngBf16<C>::NG):
    two chunks of 8 channels each, an item (pixel, 16 queries, group)."""
    return C // 16


def ang_bf16_smem(C: int, bf16_io: bool) -> int:
    """Shared memory of a block of K1's all-bf16 forms (AngBf16<C>::bytes):
    the bf16 weights, q, k, v [144, C + 8] and the attention output [128, C +
    8] in bf16, pass 1's maxima [144, C / 16] in f32, and two stages of x
    [128, C + 8] in the IO type."""
    ld = C + 8
    return (2 * 8 * C * C + 3 * ANG_BF16_ROWS * ld * 2 + RG_M * ld * 2
            + ANG_BF16_ROWS * ang_bf16_groups(C) * 4 + 2 * RG_M * ld * (2 if bf16_io else 4))


def ang_bwd_tok_smem(C: int) -> int:
    """Shared memory of a K4 step a block: three [128, C + 4] tiles (x / x2
    / dx2, xn / attn / xn2, dout), a hidden chunk [128, hc + 4], the 8
    warps' LN2 sums [8, 2, C], the ring and its two mbarriers a slot
    (AngBwdTok<C>::BYTES)."""
    tiles = (RG_M * (3 * (C + 4) + hidden_chunk(C) + 4) + 16 * C) * 4
    slots = ring_slots(tiles + 16 * 8)
    return tiles + slots * RG_SF * 4 + 2 * slots * 8


def qkv_ln_bwd_passes(W: int) -> int:
    """Passes of K3.d / K4 c over a block's tiles (QkvLnBwd<W>::ONE): one
    where the three weights split, three row tiles and the LN1 sums fit
    (W <= 64), else three with one weight resident each."""
    return 1 if (3 * 2 * W * W + 3 * RG_M * (W + 4) + 16 * W) * 4 <= RG_SMEM_MAX else 3


def qkv_ln_bwd_smem(W: int) -> int:
    """Shared memory of a K3.d / K4 c block: the weights and row tiles a
    pass holds (three of each, or one) and the 8 warps' LN1 sums [8, 2, W]
    (QkvLnBwd<W>::BYTES)."""
    held = 3 if qkv_ln_bwd_passes(W) == 1 else 1
    return (held * 2 * W * W + held * RG_M * (W + 4) + 16 * W) * 4
