"""A run of each cell with its timed path broken underneath, the look
for a card skipped: ``correct`` comes out false for each fault the cell
can have (a training step that leaves its state unchanged; half of the
batch left out, the mean taken over the rest; a result altered where it
is produced). One chip only, so no exchange between chips to leave
out."""
import pytest
from conftest import run_tiny, tiny
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.train import trainer as TR

RENDER_CELLS = ["gen_depth.exact", "gen_cv.exact", "gen_depth.focus"]


def broken_chunks(monkeypatch, method, how):
    real = getattr(R.NeurayRenderer, method)

    def broken(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        for k in ("pixel_colors_nr", "pixel_colors_nr_fine"):
            v = out[k].clone()
            if how == "half_batch":      # every second ray never rendered
                v[:, 1::2] = 0
            else:                        # every 32nd ray's colour altered
                v[:, ::32] = v[:, ::32] + 0.05
            out[k] = v
        return out

    monkeypatch.setattr(R.NeurayRenderer, method, broken)


@pytest.mark.parametrize("cell", RENDER_CELLS)
def test_sound_run_is_correct(cell):
    wl = tiny(cell)
    if cell == "gen_depth.focus":      # the f32 route at a test's size
        wl["route"].update(use_bf16=False, gather_quant="none")
    res, _ = run_tiny(cell, 5, wl)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("how", ["half_batch", "altered"])
@pytest.mark.parametrize("cell", RENDER_CELLS)
def test_broken_render_is_caught(monkeypatch, cell, how):
    method = ("render_chunk_focus" if cell == "gen_depth.focus"
              else "render_chunk")
    broken_chunks(monkeypatch, method, how)
    res, _ = run_tiny(cell, 5)
    assert res["correct"] is False, res["checks"]


def test_training_state_left_unchanged_is_caught(monkeypatch):
    real = TR.adam_update

    def unchanged(optimizer, *args, **kwargs):
        step = optimizer.step
        optimizer.step = lambda *a, **k: None
        try:
            return real(optimizer, *args, **kwargs)
        finally:
            optimizer.step = step

    monkeypatch.setattr(TR, "adam_update", unchanged)
    res, checks = run_tiny("gen_depth.train")
    assert res["correct"] is False
    assert {c.name for c in checks if not c.ok} >= {"change_gap_median"}


def test_training_half_batch_is_caught(monkeypatch):
    real = TR.Trainer._losses

    def half(self, batch):
        que = batch["que"]
        n = que["coords"].shape[1] // 2
        return real(self, dict(batch, que=dict(
            que, coords=que["coords"][:, :n])))

    monkeypatch.setattr(TR.Trainer, "_losses", half)
    res, _ = run_tiny("gen_depth.train")
    assert res["correct"] is False, res["checks"]
