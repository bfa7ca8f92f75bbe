"""One-call inference helpers, the PnP-VCVE subset of the JAX package's
``pnp_vcve_tpu/apis.py`` (itself the counterpart of the reference's
``mmedit/apis``).

- :func:`init_model` builds a config's restorer generator (the restorer
  kind, or the centre-frame kind: STDF, MFQEv2, DCNGAN, MW-GAN) on an
  explicit device (``'cuda'`` by default: the kernels; ``'cpu'``: their
  plain versions) and loads a checkpoint into it: an :class:`InferenceModel`.
- :func:`restoration_video_inference` enhances a frame directory (or a
  video file). PnP-VCVE reads the codec priors from the dataset's sidecars:
  MV records rasterized by ``data.mv_raster.rasterize_clip``, QP and slice
  types from ``data.qp_slice.QpSliceLookup``; ``max_seq_len`` runs the
  clip as independent windows (``train.eval.enhance_clip``). An
  image-input model (the centre-frame baselines, vanilla BasicVSR++) runs
  JAX's branch (:472-505): a reflect-padded sliding window with
  ``window_size > 0``, else the whole clip or ``max_seq_len`` pieces.
- :func:`restoration_inference` enhances one image as a clip of one frame
  with neutral priors (zero MVs, an I slice, mid QP): the serving handler's
  contract (tools/torch_serving_handler.py).
- :func:`init_random_seed`, :func:`set_random_seed`.
- :func:`single_gpu_test`, :func:`multi_gpu_test`: the dataset test loops
  (JAX apis.py:675-689; reference apis/test.py), thin aliases of
  ``train.eval.evaluate_dataset``.

The other kinds of the JAX module (inpainting, matting, generation, face
and interpolation helpers, single-image and reference-based restoration)
are ROADMAP Queue A item 8: their models are not ported.
"""

from __future__ import annotations

import glob
import os
import os.path as osp
import random
import re
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

__all__ = [
    "InferenceModel",
    "init_model",
    "init_random_seed",
    "set_random_seed",
    "restoration_inference",
    "restoration_video_inference",
    "single_gpu_test",
    "multi_gpu_test",
]

VIDEO_EXTENSIONS = (".mp4", ".mov")
_RESTORER_TYPES = ("Restorer", "BasicVSR", "BasicRestorer")
_CENTER_TYPES = ("CenterFrameRestorer", "STDF", "MFQEv2Restorer", "DCNGAN", "WMGAN")

# the single-image contract's neutral priors (the JAX handler's
# PnPServingHandler._clip_inputs): I slices, zero MVs and partitions
NEUTRAL_QP = 30.0 / 51.0
NEUTRAL_BASE_QP = 15.0 / 255.0
I_SLICE = 73.0  # ord('I')


@dataclass
class InferenceModel:
    """A config's generator, built on ``device`` with its weights loaded
    (the reference's ``init_model`` returns the ``nn.Module`` with ``cfg``
    attached)."""

    cfg: Any
    generator: nn.Module
    device: torch.device
    checkpoint: Optional[str] = None


def init_model(config, checkpoint: Optional[str] = None, device="cuda") -> InferenceModel:
    """Build the generator of ``config`` (a file path, a dict or a
    ``Config``) on ``device`` and load ``checkpoint`` (a ``.pth``/``.npz``
    state dict under the reference's names, a training checkpoint of
    tools/torch_train.py; ``None`` or ``'-'`` keeps the seeded random init).
    ``device='cuda'`` fails when there is no GPU; it never falls back."""
    from pnp_vcve_torch.core.builder import build_restorer
    from pnp_vcve_torch.core.checkpoint import load_generator_weights
    from pnp_vcve_torch.core.config import Config

    if isinstance(config, (str, os.PathLike)):
        cfg = Config.fromfile(config)
    elif isinstance(config, dict):
        cfg = Config(dict(config))
    else:
        cfg = config
    mtype = dict(cfg.model).get("type", "Restorer")
    if mtype not in _RESTORER_TYPES + _CENTER_TYPES:
        raise NotImplementedError(
            f"init_model: model type {mtype!r} is not ported to the PyTorch port yet "
            "(ROADMAP Queue A item 8)"
        )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_model(device='cuda'): no CUDA device is available")
    generator = build_restorer(cfg.model, cfg.get("test_cfg"), device=device).generator
    if checkpoint not in (None, "-"):
        load_generator_weights(generator, checkpoint)
    generator.eval()
    return InferenceModel(cfg=cfg, generator=generator, device=device, checkpoint=checkpoint)


# ---- seeds (reference apis/train.py init_random_seed / set_random_seed) --------------


def init_random_seed(seed: Optional[int] = None) -> int:
    """``seed``, or a fresh one drawn when it is None (one process: no
    broadcast needed)."""
    if seed is not None:
        return seed
    return int(np.random.randint(2**31))


def set_random_seed(seed: int, deterministic: bool = False) -> None:
    """Seed Python's, numpy's and PyTorch's generators; ``deterministic``
    also holds cuDNN to deterministic algorithms (reference train.py:66-84)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


# ---- image IO -----------------------------------------------------------------------


def _load_image(path_or_arr, gray: bool = False) -> np.ndarray:
    """PNG/JPG path or array -> float32 [0, 1] HWC (RGB) or HW (gray)."""
    if isinstance(path_or_arr, np.ndarray):
        img = path_or_arr
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return img.astype(np.float32)
    from PIL import Image

    with Image.open(path_or_arr) as im:
        im = im.convert("L" if gray else "RGB")
        return np.asarray(im, np.float32) / 255.0


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(np.asarray(img) * 255.0), 0, 255).astype(np.uint8)


def _read_video_file(path: str) -> np.ndarray:
    """Decode an .mp4/.mov into (t, h, w, 3) float32 RGB (needs OpenCV)."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(bgr[..., ::-1].astype(np.float32) / 255.0)
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)


def _read_frame_dir(img_dir: str, filename_tmpl: str, start_idx: int) -> np.ndarray:
    """The frames of ``img_dir`` (sorted, or named by ``filename_tmpl`` from
    ``start_idx`` when they all are) or of a video file -> (t, h, w, 3)."""
    if img_dir.lower().endswith(VIDEO_EXTENSIONS):
        return _read_video_file(img_dir)
    paths = sorted(glob.glob(osp.join(img_dir, "*")))
    named = [osp.join(img_dir, filename_tmpl.format(start_idx + i)) for i in range(len(paths))]
    if all(osp.exists(p) for p in named):
        paths = named
    return np.stack([_load_image(p) for p in paths])


def _pnp_generator(model: InferenceModel):
    from pnp_vcve_torch.models.pnp_vcve import PnPVCVE

    gen = model.generator
    if not isinstance(gen, PnPVCVE):
        raise NotImplementedError(
            f"{type(gen).__name__}: single-image restoration serves PnP-VCVE only; the SISR "
            "models are not ported to the PyTorch port yet (ROADMAP Queue A item 8)"
        )
    return gen


# ---- inference ------------------------------------------------------------------------


def restoration_video_inference(
    model: InferenceModel,
    img_dir: str,
    window_size: int = -1,
    start_idx: int = 0,
    filename_tmpl: str = "{:08d}.png",
    max_seq_len: Optional[int] = None,
    mv_dir: Optional[str] = None,
    qp_slice_file: Optional[str] = None,
    base_qp: float = 32.0,
) -> np.ndarray:
    """Enhance the clip in ``img_dir`` -> (t, h, w, 3) float32 (x4 for a VSR
    model).

    PnP-VCVE: the codec priors come from the dataset's sidecar layout:
    ``mv_dir`` holds one ``.npy`` of MV records per frame (named by
    ``filename_tmpl``), ``qp_slice_file`` the QP/slice JSON, read under the
    CRF found in ``img_dir`` (``crf<N>``; else ``base_qp``). Missing priors
    are neutral: zero MVs and partitions, and without a QP file QP 0, an I
    slice first and P slices after. ``max_seq_len`` runs the clip as
    independent windows of that many frames; ``window_size`` does not apply
    and is ignored, as in the JAX package.

    Image-input models (JAX :472-505) take the frames alone: with
    ``window_size > 0`` each frame is the output of the window of that many
    frames around it, the clip reflect-padded at both ends (reference
    pad_sequence), taken as is when the model returns the centre frame or as
    the window's middle frame when it returns the window; with ``window_size
    <= 0`` the model runs on the whole clip, or on consecutive pieces of
    ``max_seq_len`` frames.
    """
    from pnp_vcve_torch.models.pnp_vcve import PnPVCVE

    lq = _read_frame_dir(img_dir, filename_tmpl, start_idx)  # (t, h, w, 3) in [0, 1]
    if isinstance(model.generator, PnPVCVE):
        return _pnp_video(model.generator, lq, img_dir, start_idx, filename_tmpl, max_seq_len,
                          mv_dir, qp_slice_file, base_qp)
    return _image_input_video(model, lq, window_size, max_seq_len)


def _image_input_video(model: InferenceModel, lq: np.ndarray, window_size: int,
                       max_seq_len: Optional[int]) -> np.ndarray:
    gen = model.generator

    def fwd(frames):  # (k, h, w, 3) -> the model's output for one clip
        x = torch.as_tensor(np.ascontiguousarray(frames[None]), device=model.device)
        with torch.inference_mode():
            return gen(x)[0].float().cpu().numpy()

    t = lq.shape[0]
    if window_size > 0:
        pad = window_size // 2
        padded = np.concatenate([lq[1:1 + pad][::-1], lq, lq[-1 - pad:-1][::-1]], axis=0)
        outs = []
        for i in range(t):
            out = fwd(padded[i:i + window_size])
            outs.append(out if out.ndim == 3 else out[out.shape[0] // 2])
        return np.stack(outs).astype(np.float32)
    if max_seq_len is None:
        return fwd(lq).astype(np.float32)
    return np.concatenate([fwd(lq[s:s + max_seq_len]) for s in range(0, t, max_seq_len)],
                          axis=0).astype(np.float32)


def _pnp_video(gen, lq, img_dir, start_idx, filename_tmpl, max_seq_len, mv_dir, qp_slice_file,
               base_qp) -> np.ndarray:
    from pnp_vcve_torch.data.mv_raster import rasterize_clip
    from pnp_vcve_torch.data.pipeline import rescale_to_zero_one
    from pnp_vcve_torch.data.qp_slice import QpSliceLookup
    from pnp_vcve_torch.train.eval import enhance_clip
    from pnp_vcve_torch.train.train_step import make_eval_step

    t, h, w, _ = lq.shape
    clip = osp.basename(osp.normpath(img_dir))
    # the last 'crf<N>' of the path, as the datasets read it (data/datasets.py: _base_qp)
    found = re.findall(r"crf(\d+)", img_dir)
    bq = int(found[-1]) if found else int(base_qp)
    lut = QpSliceLookup(qp_slice_file)
    pairs = [lut(bq if qp_slice_file else 0, clip, start_idx + i) for i in range(t)]
    slice_types = [p[1] for p in pairs]
    if mv_dir is not None:
        recs = [np.load(osp.join(mv_dir, filename_tmpl.format(start_idx + i)[:-4] + ".npy"))
                for i in range(t)]
        mvs, partitions = rasterize_clip(recs, slice_types, h, w)
    else:
        mvs = np.zeros((t, h, w, 4), np.float32)
        partitions = np.zeros((t, h, w, 3), np.float32)
    # the raw sample, normalised as the test dataset does it (partitions
    # rescaled, MVs left in pixels)
    sample = {
        "lq": (lq * 255.0).astype(np.float32),
        "qps": np.asarray([p[0] for p in pairs], np.float32),
        "slices": np.asarray([ord(s) for s in slice_types], np.float32),
        "mvs": mvs,
        "base_qps": np.full((t,), float(bq), np.float32),
        "partitions": partitions,
    }
    rescale_to_zero_one(sample)
    return enhance_clip(make_eval_step(gen), sample, chunk_t=max_seq_len).astype(np.float32)


def restoration_inference(model: InferenceModel, img, ref=None) -> np.ndarray:
    """Enhance one image (a path or an array) -> (h, w, 3) float32 in
    [0, 1]: a clip of one frame with neutral priors (an I slice, QP 30/51,
    base QP 15/255, zero MVs and partitions). Reference-based restoration
    (``ref``) is ROADMAP Queue A item 8."""
    from pnp_vcve_torch.train.train_step import make_eval_step

    if ref is not None:
        raise NotImplementedError("reference-based restoration is not ported to the PyTorch "
                                  "port yet (ROADMAP Queue A item 8)")
    gen = _pnp_generator(model)
    lq = _load_image(img)
    h, w, _ = lq.shape
    batch = dict(
        lq=lq[None, None],
        qps=np.full((1, 1), NEUTRAL_QP, np.float32),
        slices=np.full((1, 1), I_SLICE, np.float32),
        mvs=np.zeros((1, 1, h, w, 4), np.float32),
        base_qps=np.full((1, 1), NEUTRAL_BASE_QP, np.float32),
        partitions=np.zeros((1, 1, h, w, 3), np.float32),
    )
    out = make_eval_step(gen)(batch)
    return np.clip(out[0, 0], 0.0, 1.0).astype(np.float32)


# ---- dataset-level test loops (reference apis/test.py:13-126) -------------------------


def single_gpu_test(restorer, dataset, **kwargs):
    """Whole-dataset eval on this process's device: the dataset mean of the
    clip metrics. Thin alias of ``train.eval.evaluate_dataset``."""
    from pnp_vcve_torch.train.eval import evaluate_dataset

    return evaluate_dataset(restorer, dataset, **kwargs)


def multi_gpu_test(restorer, dataset, **kwargs):
    """Multi-process eval: each rank of the initialised process group takes
    its share of the clips, and the dataset mean is the exact count-weighted
    reduction over the ranks (the reference's pickle gathers, apis/test.py:
    129-234). ``evaluate_dataset`` with ``distributed=True`` unless given."""
    from pnp_vcve_torch.train.eval import evaluate_dataset

    kwargs.setdefault("distributed", True)
    return evaluate_dataset(restorer, dataset, **kwargs)
