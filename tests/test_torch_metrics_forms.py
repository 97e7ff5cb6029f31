"""The port's PSNR/SSIM (`lft_torch/ops/metrics.py`) against lft_tpu's on
the input forms lft_tpu's `cal_metrics` takes beyond the 2-D and 3-D
mosaics (tests/test_metrics.py's 4-D and 5-D cases), and SSIM's filter
under the process's TF32 flag.

* the 4-D `[B, C, H, W]` batch (channel 0) and the 5-D `[C, U, V, h, w]`
  per-view tensor, each on the same numpy inputs through both packages:
  PSNR within 1e-5 and SSIM within 1e-6 of lft_tpu's, and of the port's
  own 2-D mosaic path;
* a rectangular 4-D input raises ValueError naming "square" in both;
* the gaussian filter's two convolutions run with cuDNN's TF32 off
  whatever the caller set (lft_tpu's run at HIGHEST precision), and the
  flag is the caller's again afterwards. On the card SSIM under
  `--matmul_precision high` equals SSIM under `highest` bit for bit
  (tests/test_torch_cuda.py, `chip_smoke.py` step 28).
"""

import numpy as np
import pytest
import torch

from lft_tpu.ops import metrics as j_metrics
from lft_torch.ops import metrics

A, HW = 3, 16


def _pair():
    rng = np.random.RandomState(5)
    label = rng.rand(A * HW, A * HW).astype(np.float32)
    out = np.clip(label + 0.05 * rng.randn(*label.shape).astype(np.float32), 0, 1)
    return rng, label, out


def _forms():
    rng, label, out = _pair()
    other = lambda: rng.rand(*label.shape).astype(np.float32)
    l4, o4 = np.stack([label, other()])[None], np.stack([out, other()])[None]
    view = lambda m: m.reshape(A, HW, A, HW).transpose(0, 2, 1, 3)[None]
    return {"2d": (label, out), "4d": (l4, o4), "5d": (view(label), view(out))}


@pytest.mark.parametrize("form", ["4d", "5d"])
def test_cal_metrics_forms_match_lft_tpu(form):
    forms = _forms()
    label, out = forms[form]
    p, s = metrics.cal_metrics(torch.from_numpy(np.ascontiguousarray(label)),
                               torch.from_numpy(np.ascontiguousarray(out)), A)
    jp, js = j_metrics.cal_metrics(label, out, A)
    assert abs(float(p) - float(jp)) < 1e-5 and abs(float(s) - float(js)) < 1e-6
    p2, s2 = metrics.cal_metrics(*(torch.from_numpy(t) for t in forms["2d"]), A)
    assert abs(float(p) - float(p2)) < 1e-5 and abs(float(s) - float(s2)) < 1e-6


def test_cal_metrics_rectangular_4d_raises_in_both():
    l4, o4 = _forms()["4d"]
    l4, o4 = l4[..., :-A], o4[..., :-A]
    with pytest.raises(ValueError, match="square"):
        metrics.cal_metrics(torch.from_numpy(np.ascontiguousarray(l4)),
                            torch.from_numpy(np.ascontiguousarray(o4)), A)
    with pytest.raises(ValueError, match="square"):
        j_metrics.cal_metrics(l4, o4, A)


@pytest.mark.parametrize("caller", [True, False])
def test_ssim_filter_runs_without_tf32(monkeypatch, caller):
    seen = []
    conv1d = metrics.F.conv1d

    def spy(*a, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv1d(*a, **kw)

    monkeypatch.setattr(metrics.F, "conv1d", spy)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = caller
    try:
        _, label, out = _pair()
        s = metrics.ssim(torch.from_numpy(label)[None], torch.from_numpy(out)[None])
        assert torch.backends.cudnn.allow_tf32 is caller
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert seen == [False] * 10       # 5 filtered maps, two passes each
    assert abs(float(s[0]) - float(j_metrics.ssim(label, out))) < 1e-6
