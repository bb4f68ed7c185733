"""Structure of the PyTorch port: it never imports JAX or the JAX package,
its entry points default to the card and raise without one, its kernel
wrappers count only real launches, and chip_smoke.py refuses to run (and
prints no result) without a card or without the rest of the repository."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rvc_tpu_torch.ops import attention, resblock, retrieval, wavenet

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "rvc_tpu")


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def _port_files():
    return sorted((REPO / "rvc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    bad = {n for n in _imported(path) if n.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, rvc_tpu_torch.pipelines.convert, rvc_tpu_torch.train.step, "
            "rvc_tpu_torch.train.data, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'rvc_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from rvc_tpu_torch.pipelines.convert import make_random_converter

    with pytest.raises(RuntimeError, match="CUDA"):
        make_random_converter("48k_v2")
    from rvc_tpu_torch import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from rvc_tpu_torch.config import preset
    from rvc_tpu_torch.train.step import Trainer

    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(preset("48k_v2"))


def test_wrappers_count_only_kernel_launches(rng):
    """On CPU tensors the wrappers run their plain versions and count nothing."""
    counters = (resblock.fused_resblock_group, attention.banded_rel_attention,
                retrieval.nearest_rows_q, retrieval.nearest_rows, resblock.fused_resblock1,
                resblock.fused_resblock1_backward, wavenet.fused_wn, wavenet.fused_wn_backward)
    before = [f.launches for f in counters]
    x = torch.from_numpy(rng.standard_normal((1, 20, 4)).astype(np.float32))
    w, b = torch.zeros(4, 4, 3), torch.zeros(4)
    resblock.fused_resblock_group(x, [[(w, b, 3, 1), (w, b, 3, 1)]])
    resblock.fused_resblock1(x, [(w, b, 3, 1), (w, b, 3, 1)])
    xg = x.clone().requires_grad_()
    resblock.fused_resblock1_train(xg, [(w, b, 3, 1), (w, b, 3, 1)]).sum().backward()
    L, C = 2, 4
    wn_args = [torch.zeros(s_, requires_grad=True) for s_ in
               ((L * 5, C, C), (L * 5, C, C), (2 * L, C), (1, 2 * L, C), (L, C, C), (L, C, C),
                (2 * L, C))]
    wavenet.fused_wn(xg, *wn_args, torch.tensor([20]), kernel_size=5).sum().backward()
    resblock.fused_resblock1_backward(x, None, x, [(w, b, 3, 1), (w, b, 3, 1)])
    wavenet.fused_wn_backward(x, None, None, x, *wn_args, torch.tensor([20]), kernel_size=5)
    q = torch.zeros(1, 1, 8, 4)
    attention.banded_rel_attention(q, q, q, torch.zeros(3, 4), torch.zeros(3, 4),
                                   torch.tensor([8]), window=1, scale=0.5)
    bank = np.ones((5, 4), np.float32)
    bq, s = retrieval.quantize_bank(bank)
    retrieval.nearest_rows_q(torch.zeros(2, 4), torch.from_numpy(bq), torch.from_numpy(s))
    retrieval.nearest_rows(torch.zeros(2, 4), torch.from_numpy(bank))
    assert [f.launches for f in counters] == before


def _wn(B, T, C, L, k=5):
    """fused_wn's arguments after x, zeros of the right shapes."""
    shapes = ((L * k, C, C), (L * k, C, C), (2 * L, C), (B, 2 * L, C), (L, C, C), (L, C, C),
              (2 * L, C))
    return [torch.zeros(s_) for s_ in shapes] + [torch.full((B,), T)]


def _bad_inputs():
    """Inputs each CUDA wrapper must refuse before a launch (checked here on
    CPU tensors: the checks do not depend on the device)."""
    f32 = torch.float32
    x = torch.zeros(1, 10, 32)
    w, b = torch.zeros(32, 32, 3), torch.zeros(32)
    q = torch.zeros(1, 2, 10, 96)
    t = torch.zeros(21, 96)
    lens = torch.tensor([10])
    feats, bank = torch.zeros(4, 64), torch.zeros(8, 64, dtype=torch.int8)
    sc = torch.ones(8, 1)
    return {
        "resblock C not a multiple of 16": (resblock._check, torch.zeros(1, 10, 20),
                                            [[(torch.zeros(20, 20, 3), torch.zeros(20), 3, 1)] * 2]),
        "resblock C above 256": (resblock._check, torch.zeros(1, 10, 272),
                                 [[(torch.zeros(272, 272, 3), torch.zeros(272), 3, 1)] * 2]),
        "resblock odd conv count": (resblock._check, x, [[(w, b, 3, 1)] * 3]),
        "resblock even kernel": (resblock._check, x, [[(torch.zeros(32, 32, 4), b, 4, 1)] * 2]),
        "resblock float64 weight": (resblock._check, x, [[(w.double(), b, 3, 1)] * 2]),
        "resblock no bias": (resblock._check, x, [[(w, None, 3, 1)] * 2]),
        "attention D 48": (attention._check, *(torch.zeros(1, 2, 10, 48),) * 3,
                           torch.zeros(21, 48), torch.zeros(21, 48), lens, 10),
        "attention window 17": (attention._check, q, q, q, torch.zeros(35, 96),
                                torch.zeros(35, 96), lens, 17),
        "attention non-contiguous q": (attention._check, q.transpose(2, 3).contiguous()
                                       .transpose(2, 3), q, q, t, t, lens, 10),
        "attention table shape": (attention._check, q, q, q, t[:20], t, lens, 10),
        "attention lengths shape": (attention._check, q, q, q, t, t, torch.tensor([1, 2]), 10),
        "nearest D 48": (retrieval._check, torch.zeros(4, 48),
                         torch.zeros(8, 48, dtype=torch.int8), sc),
        "nearest int8 bank without scales": (retrieval._check, feats, bank, None),
        "nearest float bank with scales": (retrieval._check, feats, bank.to(f32), sc),
        "nearest scales shape": (retrieval._check, feats, bank, torch.ones(8)),
        "nearest float64 queries": (retrieval._check, feats.double(), bank, sc),
        "chain mixed kernel sizes": (resblock._check_chain, x,
                                     [(w, b, 3, 1), (torch.zeros(32, 32, 5), b, 5, 1)]),
        "chain dilated second conv": (resblock._check_chain, x, [(w, b, 3, 1), (w, b, 3, 3)]),
        "wn C 200": (wavenet._check, torch.zeros(1, 10, 200), *_wn(1, 10, 200, 3), 5),
        "wn even kernel": (wavenet._check, torch.zeros(1, 10, 32), *_wn(1, 10, 32, 3, k=4), 4),
        "wn g_ab shape": (wavenet._check, torch.zeros(2, 10, 32), *_wn(1, 10, 32, 3), 5),
        "wn float64 x": (wavenet._check, torch.zeros(1, 10, 32).double(), *_wn(1, 10, 32, 3), 5),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_kernel_wrappers_refuse_bad_inputs(case):
    fn, *args = _bad_inputs()[case]
    with pytest.raises(ValueError):
        fn(*args)


def test_kernel_wrappers_accept_main_path_inputs():
    x = torch.zeros(2, 10, 256)
    resblock._check(x, [[(torch.zeros(256, 256, 11), torch.zeros(256), 11, 5)] * 6] * 3)
    q = torch.zeros(2, 2, 10, 96)
    attention._check(q, q, q, torch.zeros(21, 96), torch.zeros(21, 96), torch.tensor([10, 7]), 10)
    retrieval._check(torch.zeros(4, 768), torch.zeros(8, 768, dtype=torch.int8),
                     torch.ones(8, 1))
    resblock._check_chain(torch.zeros(4, 10, 32), [(torch.zeros(32, 32, 11), torch.zeros(32),
                                                    11, d_) for d in (1, 3, 5) for d_ in (d, 1)])
    wavenet._check(torch.zeros(4, 10, 192), *_wn(4, 10, 192, 16), 5)


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    runs = [REPO]
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs.append(tmp_path)
    for cwd in runs:
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
