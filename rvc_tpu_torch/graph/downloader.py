"""Model catalog and download helper (``rvc_tpu/graph/downloader.py``).

The catalog names the same model files as the JAX package's, so the same
ids resolve. A download is stdlib ``urllib``, attempted only when the
file is not on disk already; a failed one returns False (offline: point a
node's ``model_path`` at local files).
"""
from __future__ import annotations

import os
import urllib.request
import zipfile

BASE_MODELS_DIR = os.environ.get(
    "RVC_TPU_MODELS_DIR", os.path.join(os.path.expanduser("~"), ".rvc_tpu", "models")
)

RVC_DOWNLOAD_LINK = "https://huggingface.co/datasets/SayanoAI/RVC-Studio/resolve/main/"

MDX_MODELS = ["MDXNET/UVR-MDX-NET-vocal_FT.onnx"]
KARAFAN_MODELS = ["karafan/MDX23C-8KFFT-InstVoc_HQ.ckpt"]
VR_MODELS = [
    "UVR/UVR-DeEcho-DeReverb.pth",
    "UVR/HP5-vocals+instrumentals.pth",
    "UVR/5_HP-Karaoke-UVR.pth",
    "UVR/6_HP-Karaoke-UVR.pth",
    "UVR/model_bs_roformer_ep_317_sdr_12.9755.ckpt",
    "UVR/UVR-BVE-4B_SN-44100-1.pth",
    "UVR/UVR-DeNoise.pth",
]
RVC_MODELS = ["RVC/Claire.pth", "RVC/Sayano.pth", "RVC/Mae_v2.pth", "RVC/Fuji.pth",
              "RVC/Monika.pth"]
RVC_INDEX = [
    "RVC/.index/added_IVF1063_Flat_nprobe_1_Sayano_v2.index",
    "RVC/.index/added_IVF985_Flat_nprobe_1_Fuji_v2.index",
    "RVC/.index/Monika_v2_40k.index",
    "RVC/.index/Sayano_v2_40k.index",
]
BASE_MODELS = ["content-vec-best.safetensors", "rmvpe.pt"]
VITS_MODELS = ["VITS/pretrained_ljs.pth"]
PRETRAINED_MODELS_G = [
    "pretrained_v2/G48k.pth", "pretrained_v2/G32k.pth", "pretrained_v2/G40k.pth",
    "pretrained_v2/f0G48k.pth", "pretrained_v2/f0G40k.pth", "pretrained_v2/f0G32k.pth",
    "pretrained_v2/f0_RIN_E3_40k_G.pth",
    "pretrained_v2/f0Ov2Super32kG.pth", "pretrained_v2/f0Ov2Super40kG.pth",
]
PRETRAINED_MODELS_D = [
    "pretrained_v2/D48k.pth", "pretrained_v2/D32k.pth", "pretrained_v2/D40k.pth",
    "pretrained_v2/f0D48k.pth", "pretrained_v2/f0D40k.pth", "pretrained_v2/f0D32k.pth",
    "pretrained_v2/f0_RIN_E3_40k_D.pth",
    "pretrained_v2/f0Ov2Super32kD.pth", "pretrained_v2/f0Ov2Super40kD.pth",
]
UVR_MODELS = MDX_MODELS + KARAFAN_MODELS + VR_MODELS
PRETRAINED_MODELS = PRETRAINED_MODELS_G + PRETRAINED_MODELS_D


def download_file(params: tuple[str, str], chunk_size: int = 1 << 20) -> bool:
    """Stream ``url`` into ``path`` (through ``path + ".part"``) unless the
    file exists; True when the file is there afterwards."""
    path, url = params
    if os.path.exists(path):
        return True
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".part"
    try:
        with urllib.request.urlopen(url) as r, open(tmp, "wb") as f:
            while True:
                chunk = r.read(chunk_size)
                if not chunk:
                    break
                f.write(chunk)
        os.replace(tmp, path)
        return True
    except (OSError, ValueError) as e:  # offline, an HTTP error, a malformed URL
        print(f"download failed for {url}: {e}")
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def model_downloader(model_name: str) -> str | None:
    """A catalog model's path under ``BASE_MODELS_DIR``, downloaded if
    missing; None when the download failed."""
    dest = os.path.join(BASE_MODELS_DIR, model_name)
    if os.path.exists(dest):
        return dest
    ok = download_file((dest, RVC_DOWNLOAD_LINK + model_name))
    return dest if ok else None


def extract_zip_without_structure(zip_path: str, out_dir: str) -> list[str]:
    """Every file of a zip into ``out_dir`` without its folders; returns the
    paths written."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    with zipfile.ZipFile(zip_path) as zf:
        for info in zf.infolist():
            if info.is_dir():
                continue
            name = os.path.basename(info.filename)
            if not name:
                continue
            target = os.path.join(out_dir, name)
            with zf.open(info) as src, open(target, "wb") as dst:
                dst.write(src.read())
            written.append(target)
    return written
