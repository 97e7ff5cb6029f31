"""`lft_torch.profile_scene.device_ms` on traces that hold no device time:
it traces again, then times with CUDA events, and with a kernel filter it
raises. The profiler, the events and the card are stood in for, so this
runs on the CPU."""
import pytest
import torch

from lft_torch import profile_scene

REPS = 4


class _Avg:
    def __init__(self, key, us, count=REPS):
        self.key, self.device_time_total, self.count = key, us, count
        self.device_type = torch.autograd.DeviceType.CUDA


class _Trace:
    def __init__(self, avgs):
        self.avgs = avgs

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return self.avgs


class _Event:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 2.0


@pytest.fixture
def fake_card(monkeypatch):
    """Installs traces that hand out the given key averages in turn; returns
    (set the traces, how many traces were taken, calls of fn)."""
    state = dict(traces=[], taken=0, calls=0)

    def profile(activities=None):
        state["taken"] += 1
        return _Trace(state["traces"].pop(0))

    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)

    def fn():
        state["calls"] += 1
    return state, fn


def test_device_ms_takes_the_first_trace_with_device_time(fake_card):
    state, fn = fake_card
    state["traces"] = [[], [_Avg("k_a", 300.0), _Avg("k_b", 100.0)]]
    assert profile_scene.device_ms(fn, REPS) == pytest.approx(400.0 / 1e3 / REPS)
    assert state["taken"] == 2 and state["calls"] == 2 + 2 * REPS
    state["traces"] = [[_Avg("k_a", 300.0), _Avg("k_b", 100.0)]]
    assert profile_scene.device_ms(fn, REPS, kernel="k_b") == pytest.approx(0.1 / REPS)


def test_device_ms_times_with_events_when_no_trace_saw_the_card(fake_card, capsys):
    state, fn = fake_card
    state["traces"] = [[], [], []]
    assert profile_scene.device_ms(fn, REPS) == pytest.approx(2.0 / REPS)
    assert state["taken"] == 3 and state["calls"] == 2 + 4 * REPS
    assert "CUDA events" in capsys.readouterr().out


def test_device_ms_with_a_kernel_filter_raises_when_no_trace_saw_it(fake_card):
    state, fn = fake_card
    state["traces"] = [[_Avg("k_a", 300.0)]] * 3
    with pytest.raises(AssertionError, match="k_b"):
        profile_scene.device_ms(fn, REPS, kernel="k_b")


def test_device_ms_traces_again_when_a_trace_lost_launches(fake_card, capsys):
    """A trace that counts a kernel fewer times than the calls launch it
    (CUPTI dropped records) is taken again; with none whole, CUDA events."""
    state, fn = fake_card
    state["traces"] = [[_Avg("k_a", 150.0, REPS - 1), _Avg("k_b", 100.0)],
                       [_Avg("k_a", 300.0), _Avg("k_b", 100.0)]]
    assert profile_scene.device_ms(fn, REPS) == pytest.approx(400.0 / 1e3 / REPS)
    assert state["taken"] == 2 and "lost launches of 'k_a'" in capsys.readouterr().out
    state["traces"] = [[_Avg("k_a", 150.0, 1)]] * 3
    assert profile_scene.device_ms(fn, REPS) == pytest.approx(2.0 / REPS)
    assert "CUDA events" in capsys.readouterr().out
