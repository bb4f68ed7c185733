"""Structure of the PyTorch port: it never imports JAX, the JAX package or
OpenCV (the card's machine has none), its entry points default to the card
and raise without one, its kernel
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
FORBIDDEN = ("jax", "flax", "rvc_tpu", "cv2")


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


def test_simt_yardsticks_are_named_only_by_chip_smoke():
    """The entries that redesigned kernels replaced are on no path of the
    port: the float32 SIMT chain forward and backward of kernels 4, 5 and 7,
    the SIMT WN forward (kernel 6), the bf16 unit on mma.sync (kernels 1 and
    8), the SIMT kernel 2 and the first bf16 kernel 2. No module names them
    but the library's table of entry points, and chip_smoke.py times them as
    its yardsticks."""
    names = ("rvc_resblock1_fwd_simt", "rvc_resblock1_bwd_simt", "rvc_wn_fwd_simt",
             "rvc_wn_bwd_simt",
             "rvc_resblock_unit_bf16_sync", "rvc_banded_attention_simt",
             "rvc_banded_attention_bf16_sync")
    naming = {str(p.relative_to(REPO)) for p in _port_files()
              if any(n in p.read_text() for n in names)}
    assert naming == {"rvc_tpu_torch/ops/_cuda.py", "chip_smoke.py"}


def test_import_leaves_jax_unloaded():
    code = ("import sys, rvc_tpu_torch.pipelines.convert, rvc_tpu_torch.train.step, "
            "rvc_tpu_torch.train.data, rvc_tpu_torch.train.checkpoints, "
            "rvc_tpu_torch.train.summaries, rvc_tpu_torch.pipelines.train, "
            "rvc_tpu_torch.pipelines.preprocess, rvc_tpu_torch.ops.slicer, "
            "rvc_tpu_torch.retrieval.index, rvc_tpu_torch.compat.optimizer_import, "
            "rvc_tpu_torch.compat.torch_export, rvc_tpu_torch.compat.process_ckpt, "
            "rvc_tpu_torch.cli.main, rvc_tpu_torch.pitch.world, rvc_tpu_torch.models.crepe, "
            "rvc_tpu_torch.native, rvc_tpu_torch.pipelines.separate, chip_smoke, "
            "rvc_tpu_torch.pipelines.musetalk, rvc_tpu_torch.graph.musetalk_nodes, "
            "rvc_tpu_torch.ops.image, rvc_tpu_torch.ops.monotonic_align, rvc_tpu_torch.models.flows; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'rvc_tpu', 'cv2')]; "
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


def test_training_workflow_defaults_to_the_card(tmp_path):
    """The dataset build, the training run and the index take the card
    unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from rvc_tpu_torch.pipelines.preprocess import extract_features
    from rvc_tpu_torch.pipelines.train import TrainRunConfig
    from rvc_tpu_torch.retrieval.index import FeatureIndex, train_index

    with pytest.raises(RuntimeError, match="CUDA"):
        FeatureIndex(np.zeros((2, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_index(np.zeros((2, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_features(str(tmp_path), None)
    assert TrainRunConfig("run", "list.txt").device is None  # Trainer(device=None): the card


def test_separation_defaults_to_the_card(tmp_path):
    """load_separator, both separators and the CLI's separate take the card
    unless the CPU is asked for, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from rvc_tpu_torch.cli.main import main
    from rvc_tpu_torch.pipelines.separate import MDXSeparator, VRSeparator, load_separator

    for make in (lambda: VRSeparator({}), lambda: MDXSeparator({}),
                 lambda: load_separator("vr", str(tmp_path / "m.pth")),
                 lambda: load_separator("mdx", str(tmp_path / "mdx.onnx"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    wav = tmp_path / "in.wav"
    from scipy.io import wavfile

    wavfile.write(wav, 44100, np.zeros(4410, np.int16))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["separate", str(wav), str(tmp_path / "out"), "--model", str(tmp_path / "m.pth")])


def test_musetalk_entry_points_default_to_the_card(tmp_path):
    """MuseTalkPipeline, Audio2Feature, FaceParser and the five loaders take
    the card unless the CPU is asked for, and raise without one (the
    loaders before they read the file)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from rvc_tpu_torch.models.musetalk import face, unet, vae
    from rvc_tpu_torch.models.whisper import Whisper, WhisperDims
    from rvc_tpu_torch.pipelines.musetalk import Audio2Feature, FaceParser, MuseTalkPipeline

    missing = str(tmp_path / "absent.bin")
    tiny = Whisper(WhisperDims(n_audio_state=64, n_audio_head=2, n_audio_layer=1,
                               n_text_state=64, n_text_head=2, n_text_layer=1, n_vocab=16))
    for make in (lambda: MuseTalkPipeline(None, None, None), lambda: Audio2Feature(tiny),
                 lambda: FaceParser(face.BiSeNet()), lambda: vae.load_vae(missing),
                 lambda: unet.load_unet(missing), lambda: face.load_s3fd(missing),
                 lambda: face.load_bisenet(missing), lambda: face.load_fan(missing)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert MuseTalkPipeline(None, None, None, device="cpu").device.type == "cpu"
    assert Audio2Feature(tiny, device="cpu").device.type == "cpu"


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


def test_weights_are_packed_once_per_set_of_weights():
    """``resblock.packed`` packs a set of weights once: again for the same
    storage (also through another tensor viewing it), anew after a change
    in place, and apart for other weights of the same shape."""
    calls = []

    def pack(w):
        calls.append(1)
        return w * 2

    w = torch.arange(24.0).reshape(2, 3, 4)
    first = resblock.packed(w, pack)
    assert resblock.packed(w, pack) is first and resblock.packed(w.detach(), pack) is first
    assert len(calls) == 1
    with torch.no_grad():
        w.mul_(3)
    again = resblock.packed(w, pack)
    assert len(calls) == 2 and torch.equal(again, w * 2)
    other = w.clone()
    assert resblock.packed(other, pack) is not again and len(calls) == 3
    wide = torch.ones(16, 16, 3)  # a width the bf16 packing takes
    assert resblock.packed(wide, resblock.pack_bf16_weights) is not resblock.packed(wide, pack)


def test_weights_with_autograd_history_are_packed_and_not_kept():
    """Weights that carry autograd history (weight norm folds them anew every
    training step) are packed at every call and never enter the cache, which
    would keep each step's weights alive; a leaf that wants gradients is
    cached as any other tensor."""
    calls = []

    def pack(ws):
        calls.append(1)
        return torch.stack(ws).detach() * 2

    leaf = torch.arange(24.0).reshape(2, 3, 4).requires_grad_()
    kept = len(resblock._pack_cache)
    for step in range(3):
        folded = leaf * 1.0
        assert torch.equal(resblock.packed((folded, leaf), pack)[0], leaf.detach() * 2)
        assert len(calls) == step + 1 and len(resblock._pack_cache) == kept
    first = resblock.packed((leaf,), pack)
    assert resblock.packed((leaf,), pack) is first and len(resblock._pack_cache) == kept + 1


def test_swizzle_refuses_rows_not_in_groups_of_8():
    """The 128-byte swizzle permutes chunks within each group of 8 rows and is
    its own inverse; a row count not a multiple of 8 is refused."""
    v = torch.arange(16 * 8 * 3.0).reshape(16, 8, 3)
    once = resblock._swizzle(v)
    assert torch.equal(once[9, 2], v[9, 2 ^ 1]) and torch.equal(resblock._swizzle(once), v)
    with pytest.raises(ValueError):
        resblock._swizzle(v[:12])
