"""Lip sync with MuseTalk: Whisper features per video frame, a face box
per frame, one UNet step in the VAE's latent space, and the generated
mouth pasted back.

Counterpart of ``rvc_tpu/pipelines/musetalk.py`` (the reference's
custom_nodes/musetalk_nodes.py and lib/musetalk/):

1. ``Audio2Feature``: each 30 s window of 16 kHz audio through the Whisper
   encoder with every block's output; ``ceil(n / 320)`` rows a window
   (50 Hz), and for each video frame a window of 2 (2 + 2 + 1) rows around
   it (``get_sliced_feature``).
2. A box per frame: S3FD's best candidate (the first box NMS would keep),
   optionally refined by FAN's 68 landmarks.
3. The crop resized to 256 (Lanczos-4), encoded twice by the VAE (its top
   half alone, and whole), the two latents stacked to 8 channels, the UNet
   at t = 0 on the last encoder layer's rows with positional encoding,
   decoded to 256 x 256.
4. The face pasted back: feathered over the box, or, with BiSeNet, over
   the parsed jaw region of the expanded square crop.

The networks run on the pipeline's device; the resizes, blurs and the
paste-back run on the host in numpy through ``ops.image`` (OpenCV's
arithmetic), where the JAX package calls ``cv2``. The port never imports
``cv2``. Frames are uint8 RGB (H, W, 3); boxes (x1, y1, x2, y2).
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch

from ..device import resolve_device, set_float32_math
from ..models.musetalk.face import decode_s3fd, first_kept, heatmaps_to_landmarks
from ..models.musetalk.unet import positional_encoding
from ..models.musetalk.vae import postprocess_image, preprocess_image
from ..models.whisper import log_mel_spectrogram
from ..ops.image import INTER_NEAREST, gaussian_blur, resize

WINDOW = 30 * 16000  # samples of audio a Whisper window


class Audio2Feature:
    """Per-video-frame Whisper features from a ``Whisper`` model (the STT
    loader's entry holds it under "model" and its dims under "dims"), moved
    to ``device`` (None: the card)."""

    def __init__(self, whisper, dims=None, device=None):
        self.device = resolve_device(device)
        set_float32_math()
        self.model = whisper.to(self.device).eval()
        self.dims = dims if dims is not None else whisper.dims

    @torch.no_grad()
    def audio2feat(self, audio: np.ndarray) -> np.ndarray:
        """(T,) at 16 kHz -> (frames at 50 Hz, encoder layers, width): each
        30 s window zero-padded and embedded, its first ceil(n / 320) rows
        kept."""
        feats = []
        for start in range(0, len(audio), WINDOW):
            seg = np.asarray(audio[start:start + WINDOW], np.float32)
            n_valid = int(np.ceil(len(seg) / 320))
            seg = np.pad(seg, (0, WINDOW - len(seg)))
            mel = log_mel_spectrogram(torch.from_numpy(seg)[None].to(self.device))
            _, layers = self.model.embed_audio(mel, return_layers=True)
            feats.append(layers[0].transpose(0, 1)[:n_valid].float().cpu().numpy())
        return np.concatenate(feats, axis=0)

    @staticmethod
    def get_sliced_feature(feature_array: np.ndarray, vid_idx: int,
                           audio_feat_length=(2, 2), fps: float = 25.0):
        """The 2 (l + r + 1) rows at 50 Hz around video frame ``vid_idx``,
        clamped to the array, as (rows, width); and their indices."""
        length = len(feature_array)
        center = int(vid_idx * 50 / fps)
        left = center - audio_feat_length[0] * 2
        right = center + (audio_feat_length[1] + 1) * 2
        idxs = [int(np.clip(i, 0, length - 1)) for i in range(left, right)]
        out = np.concatenate([feature_array[i] for i in idxs], axis=0)
        return out.reshape(-1, feature_array.shape[-1]), idxs

    def feature2chunks(self, feature_array: np.ndarray, fps: float,
                       audio_feat_length=(2, 2)) -> list[np.ndarray]:
        n_frames = int(len(feature_array) / 50 * fps)
        return [self.get_sliced_feature(feature_array, i, audio_feat_length, fps)[0]
                for i in range(n_frames)]


def blend_face(frame: np.ndarray, face: np.ndarray, box: tuple[int, int, int, int],
               mask: np.ndarray | None = None, expand: float = 1.2) -> np.ndarray:
    """Paste ``face`` over ``box`` of ``frame`` with a Gaussian-feathered
    mask (a box of ones unless ``mask`` is given)."""
    x1, y1, x2, y2 = box
    face_resized = resize(face, (x2 - x1, y2 - y1))
    if mask is None:
        mask = np.ones(face_resized.shape[:2], np.float32)
    else:
        mask = resize(mask.astype(np.float32), (x2 - x1, y2 - y1))
    ks = max((x2 - x1) // 10 * 2 + 1, 3)
    mask = gaussian_blur(mask, (ks, ks))[..., None]
    out = frame.copy()
    region = frame[y1:y2, x1:x2].astype(np.float32)
    out[y1:y2, x1:x2] = (mask * face_resized + (1 - mask) * region).astype(np.uint8)
    return out


class FaceParser:
    """BiSeNet face segmentation -> a 0/255 face mask (classes 1-13): each
    crop resized to ``size`` (linear), ImageNet-normalized, the class map
    taken on the device and resized back (nearest)."""

    _MEAN = np.array([0.485, 0.456, 0.406], np.float32)
    _STD = np.array([0.229, 0.224, 0.225], np.float32)

    def __init__(self, model, size: int = 512, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.size = size

    @torch.no_grad()
    def classes(self, images: list[np.ndarray]) -> np.ndarray:
        """The class map (B, size, size) of uint8 RGB crops, one batch."""
        s = self.size
        batch = np.stack([(resize(im, (s, s)).astype(np.float32) / 255.0 - self._MEAN) / self._STD
                          for im in images])
        x = torch.from_numpy(batch.transpose(0, 3, 1, 2)).to(self.device)
        return torch.argmax(self.model(x), dim=1).cpu().numpy()

    def __call__(self, images: list[np.ndarray]) -> list[np.ndarray]:
        cls = self.classes(images)
        masks = ((cls >= 1) & (cls <= 13)).astype(np.uint8) * 255
        return [resize(m, (im.shape[1], im.shape[0]), INTER_NEAREST)
                for m, im in zip(masks, images)]


def _crop_box(box: tuple[int, int, int, int], expand: float):
    """The square crop box around ``box``, its half side ``s`` times ``expand``."""
    x, y, x1, y1 = box
    xc, yc = (x + x1) // 2, (y + y1) // 2
    s = int(max(x1 - x, y1 - y) // 2 * expand)
    return (xc - s, yc - s, xc + s, yc + s), s


def _crop_padded(img: np.ndarray, box) -> np.ndarray:
    """A crop whose area outside the image is zero (PIL's crop)."""
    x0, y0, x1, y1 = box
    h, w = img.shape[:2]
    out = np.zeros((y1 - y0, x1 - x0) + img.shape[2:], img.dtype)
    sx0, sy0 = max(x0, 0), max(y0, 0)
    sx1, sy1 = min(x1, w), min(y1, h)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0: sy1 - y0, sx0 - x0: sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return out


def blend_face_parsed(frame: np.ndarray, face: np.ndarray, box: tuple[int, int, int, int],
                      mask_crop: np.ndarray, upper_boundary_ratio: float = 0.5,
                      expand: float = 1.2) -> np.ndarray:
    """Paste ``face`` with the parsed mask of the expanded square crop, kept
    inside the box and below ``upper_boundary_ratio`` of the crop, blurred."""
    x, y, x1, y1 = box
    cbox, _ = _crop_box(box, expand)
    x_s, y_s, x_e, y_e = cbox
    face_large = _crop_padded(frame, cbox)
    ch, cw = face_large.shape[:2]

    mask = np.zeros((ch, cw), np.uint8)
    mask[y - y_s: y1 - y_s, x - x_s: x1 - x_s] = mask_crop[y - y_s: y1 - y_s, x - x_s: x1 - x_s]
    mask[: int(ch * upper_boundary_ratio)] = 0
    ks = int(0.1 * cw // 2 * 2) + 1
    mask = gaussian_blur(mask, (ks, ks)).astype(np.float32) / 255.0

    face_large[y - y_s: y1 - y_s, x - x_s: x1 - x_s] = resize(face, (x1 - x, y1 - y))

    out = frame.copy()
    dx0, dy0 = max(x_s, 0), max(y_s, 0)
    dx1, dy1 = min(x_e, frame.shape[1]), min(y_e, frame.shape[0])
    m = mask[dy0 - y_s: dy1 - y_s, dx0 - x_s: dx1 - x_s, None]
    src = face_large[dy0 - y_s: dy1 - y_s, dx0 - x_s: dx1 - x_s].astype(np.float32)
    dst = frame[dy0:dy1, dx0:dx1].astype(np.float32)
    out[dy0:dy1, dx0:dx1] = (m * src + (1 - m) * dst).astype(np.uint8)
    return out


def refine_box_with_landmarks(box: tuple[int, int, int, int], landmarks: np.ndarray,
                              bbox_shift: int = 0) -> tuple[int, int, int, int]:
    """The crop box from 68 landmarks: the top mirrored about the nose
    bridge (point 29, moved by ``bbox_shift``), the sides and bottom at the
    points' extent; ``box`` itself when that box is empty or leaves the
    frame on the left."""
    lm = np.asarray(landmarks)
    half_y = float(lm[29, 1]) + bbox_shift
    half_dist = float(np.max(lm[:, 1])) - half_y
    upper = max(0.0, half_y - half_dist)
    x1, y1 = int(np.min(lm[:, 0])), int(upper)
    x2, y2 = int(np.max(lm[:, 0])), int(np.max(lm[:, 1]))
    if y2 - y1 <= 0 or x2 - x1 <= 0 or x1 < 0:
        return box
    return (x1, y1, x2, y2)


class MuseTalkPipeline:
    """Lip sync over a frame sequence. ``vae`` (AutoencoderKL), ``unet``
    (UNet2DCondition), ``whisper`` (Audio2Feature), and optionally ``face``
    (S3FD; without it the caller gives the boxes), ``parse`` (BiSeNet;
    without it the box is feathered) and ``fan`` (FAN; without it S3FD's
    boxes are not refined). The networks are moved to ``device`` (None:
    the card)."""

    def __init__(self, vae, unet, whisper, face=None, parse=None, fan=None, device=None):
        self.device = resolve_device(device)
        set_float32_math()
        on = (lambda m: None if m is None else m.to(self.device).eval())
        self.vae, self.unet, self.face, self.fan = on(vae), on(unet), on(face), on(fan)
        self.whisper = whisper
        self.parser = FaceParser(parse, device=self.device) if parse is not None else None

    @contextmanager
    def _stage(self, stages: dict | None, name: str):
        """Adds the stage's seconds to ``stages[name]`` (the device synchronized
        at both ends) when ``stages`` is a dict."""
        if stages is None:
            yield
            return
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0

    @torch.no_grad()
    def detect_faces(self, frames: list[np.ndarray]) -> list[tuple[int, int, int, int]]:
        """A box per frame: S3FD's best candidate clipped at 0, as the
        reference's face-detection API clips it (the frame itself when there
        is none), the frames run 8 at a time. The JAX pipeline keeps a
        negative corner, whose crop is then empty and fails."""
        boxes = []
        for k in range(0, len(frames), 8):
            group = frames[k:k + 8]
            out = [o.cpu().numpy() for o in self.face(self._s3fd_input(group))]
            for b, frame in enumerate(group):
                best = first_kept(decode_s3fd([o[b:b + 1] for o in out]))
                if best is None:
                    boxes.append((0, 0, frame.shape[1], frame.shape[0]))
                else:
                    s, x1, y1, x2, y2 = np.clip(best, 0, None)
                    boxes.append((int(x1), int(y1), int(x2), int(y2)))
        return boxes

    def _s3fd_input(self, frames: list[np.ndarray]) -> torch.Tensor:
        x = np.stack([f.astype(np.float32) - np.array([104.0, 117.0, 123.0]) for f in frames])
        return torch.from_numpy(x.astype(np.float32).transpose(0, 3, 1, 2)).to(self.device)

    @torch.no_grad()
    def get_landmarks(self, frames: list[np.ndarray], boxes: list[tuple[int, int, int, int]],
                      size: int = 256) -> list[np.ndarray]:
        """68 landmarks a frame, in the frame's pixels: FAN on every crop
        (resized to ``size``) in one batch."""
        crops, metas = [], []
        for frame, (x1, y1, x2, y2) in zip(frames, boxes):
            crop = frame[y1:y2, x1:x2]
            if crop.size == 0:
                crop, x1, y1 = frame, 0, 0
            ch, cw = crop.shape[:2]
            crops.append(resize(crop, (size, size)).astype(np.float32) / 255.0)
            metas.append((x1, y1, cw, ch))
        x = torch.from_numpy(np.stack(crops).transpose(0, 3, 1, 2)).to(self.device)
        pts = heatmaps_to_landmarks(self.fan(x)).cpu().numpy()
        return [p * np.array([cw / size, ch / size]) + np.array([x1, y1])
                for p, (x1, y1, cw, ch) in zip(pts, metas)]

    @torch.no_grad()
    def process(self, frames: list[np.ndarray], audio: np.ndarray, fps: float = 25.0,
                boxes: list[tuple[int, int, int, int]] | None = None, batch_size: int = 8,
                bbox_shift: int = 0, stages: dict | None = None) -> list[np.ndarray]:
        """frames: uint8 RGB; audio: (T,) at 16 kHz -> the lip-synced frames
        (as many as both cover). ``stages``: seconds by stage, added to
        (features, detection, landmarks, VAE encode, UNet, VAE decode,
        parsing, paste-back)."""
        with self._stage(stages, "features"):
            feat_rows = self.whisper.audio2feat(audio)[:, -1]  # the last encoder layer
        if boxes is None:
            with self._stage(stages, "detection"):
                boxes = self.detect_faces(frames)
            if self.fan is not None:
                with self._stage(stages, "landmarks"):
                    landmarks = self.get_landmarks(frames, boxes)
                    boxes = [refine_box_with_landmarks(b, lm, bbox_shift)
                             for b, lm in zip(boxes, landmarks)]

        out_frames = []
        n = min(len(frames), int(len(feat_rows) / 50 * fps))
        dev = self.device
        for k in range(0, n, batch_size):
            group = list(range(k, min(k + batch_size, n)))
            with self._stage(stages, "VAE encode"):
                crops = [frames[i][boxes[i][1]:boxes[i][3], boxes[i][0]:boxes[i][2]]
                         for i in group]
                x = np.concatenate([preprocess_image(c, half_mask=True) for c in crops]
                                   + [preprocess_image(c) for c in crops])
                lat = self.vae.encode(torch.from_numpy(x).to(dev))
                lat_in = torch.cat(lat.chunk(2), dim=1)  # (B, 8, 32, 32): masked, reference
            with self._stage(stages, "UNet"):
                feats = np.stack([Audio2Feature.get_sliced_feature(feat_rows, i, (2, 2), fps)[0]
                                  for i in group]).astype(np.float32)
                audio_feat = positional_encoding(torch.from_numpy(feats).to(dev))
                pred = self.unet(lat_in, torch.zeros(len(group), device=dev), audio_feat)
            with self._stage(stages, "VAE decode"):
                imgs = postprocess_image(self.vae.decode(pred))
            if self.parser is not None:
                with self._stage(stages, "parsing"):
                    larges = [_crop_padded(frames[i], _crop_box(boxes[i], 1.2)[0]) for i in group]
                    masks = self.parser(larges)
                with self._stage(stages, "paste-back"):
                    out_frames += [blend_face_parsed(frames[i], imgs[j], boxes[i], masks[j])
                                   for j, i in enumerate(group)]
            else:
                with self._stage(stages, "paste-back"):
                    out_frames += [blend_face(frames[i], imgs[j], boxes[i])
                                   for j, i in enumerate(group)]
        return out_frames
