"""`scripts/torch_learning_demo.py` on the CPU, at a smoke size: 24 train
and 8 held-out images, one epoch, then a resume to the second. The table
is written with the three µAP rows and the loss trace, and the second
segment starts from the step the first saved. No µAP bar on the CPU (the
full run is on the card)."""

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from scripts import torch_learning_demo as demo  # noqa: E402

SMOKE = ["--device", "cpu", "--n_train", "24", "--n_val", "8", "--epochs_a", "1",
         "--epochs_b", "2", "--batch_size", "12", "--num_workers", "1", "--print_freq", "1"]


def test_demo_smoke_writes_its_table_and_resumes(tmp_path):
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = demo.main(SMOKE + ["--work_dir", str(tmp_path / "run"),
                                 "--out_md", str(tmp_path / "demo.md")])
    finally:
        torch.set_num_threads(saved)
    steps_per_epoch = 24 // 12
    assert res["saved_step"] == res["resumed_from"] == steps_per_epoch
    assert res["final_step"] == 2 * steps_per_epoch
    assert [(e, b) for e, b, _ in res["losses"]] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(np.isfinite(loss) for _, _, loss in res["losses"])
    for key in ("uap_untrained", "uap_trained", "uap_ema"):
        assert 0.0 <= res[key] <= 1.0
    table = (tmp_path / "demo.md").read_text()
    assert "the CPU (no card)" in table and "resumes from step 2 to epoch 2 (step 4)" in table
    for label, key in (("untrained (the CLI's seeded init)", "uap_untrained"),
                       ("trained", "uap_trained"), ("trained (EMA, decay 0.999)", "uap_ema")):
        assert f"| {label} | {res[key]:.4f} |" in table
    assert table.count("\nepoch ") == 4
