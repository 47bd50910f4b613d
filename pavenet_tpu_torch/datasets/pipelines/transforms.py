"""Host-side (numpy/cv2) clip pipelines (as
``pavenet_tpu/datasets/pipelines/transforms.py``): load, photometric
distortion, a shared affine warp, flip, multi-scale resize, crop,
normalise, pad to a static bucket, stack the frames. Every geometric and
photometric parameter is drawn once per clip and applied to all its
frames.

Randomness: the JAX package's transforms draw from Python's and numpy's
global streams; here each random transform draws from the generators it
is called with (``rng.py``, a ``random.Random``, and ``rng.np``, a
``np.random.RandomState``: ``utils/seed.py::Generators``), in the same
order, so generators seeded like the JAX package's globals give the same
clips. A random transform called without them raises.

Every transform takes and returns a ``results`` dict:
    imgs: list[T] of HxWx3 float32 (RGB; uint8 where LoadClip says so)
    gt_keypoints (G, K, 3), gt_bboxes (G, 4), gt_areas (G,), gt_labels (G,)
    img_shape, scale_factor, pad_shape, flip_pairs, image_id
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np

from ...utils.seed import Generators

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _need(rng: Optional[Generators], name: str) -> Generators:
    if rng is None:
        raise ValueError(f"{name} draws random parameters: call it with "
                         "generators (utils/seed.py::set_random_seed)")
    return rng


class Compose:
    """The transforms in turn, each given ``rng``; None if one drops the
    sample."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, results, rng: Optional[Generators] = None):
        for t in self.transforms:
            results = t(results, rng)
            if results is None:
                return None
        return results


class LoadClip:
    """Read the clip's frames as RGB, float32 or ``dtype``.

    ``cache_size`` > 0 keeps the last N decoded frames (uint8 RGB) in an
    LRU cache keyed by path: the test protocol's clips overlap, so
    sequential evaluation reads each frame up to T times.
    """

    def __init__(self, to_rgb: bool = True, cache_size: int = 0,
                 dtype=np.float32):
        self.to_rgb = to_rgb
        self.cache_size = cache_size
        self.dtype = np.dtype(dtype)
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()

    def _decode(self, path):
        if self.cache_size:
            cached = self._cache.get(path)
            if cached is not None:
                self._cache.move_to_end(path)
                return cached
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        if self.to_rgb:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if self.cache_size:
            self._cache[path] = img
            while len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)
        return img

    def __call__(self, results, rng=None):
        imgs = [self._decode(p) if self.dtype == np.uint8
                else self._decode(p).astype(self.dtype)
                for p in results["frame_files"]]
        results["imgs"] = imgs
        results["img_shape"] = imgs[0].shape[:2]
        results["ori_shape"] = imgs[0].shape[:2]
        results["scale_factor"] = np.array([1.0, 1.0], np.float32)
        return results


class PhotoMetricDistortion:
    """mmdet's photometric distortion, one parameter draw per clip."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, results, rng=None):
        r = _need(rng, "PhotoMetricDistortion").py
        do_bright = r.randint(0, 1)
        bright = r.uniform(-self.brightness_delta, self.brightness_delta)
        mode = r.randint(0, 1)
        do_contrast = r.randint(0, 1)
        alpha = r.uniform(self.contrast_lower, self.contrast_upper)
        do_sat = r.randint(0, 1)
        sat = r.uniform(self.saturation_lower, self.saturation_upper)
        do_hue = r.randint(0, 1)
        hue = r.uniform(-self.hue_delta, self.hue_delta)
        do_swap = r.randint(0, 1)
        perm = rng.np.permutation(3)

        def distort(img):
            img = img.copy()
            if do_bright:
                img += bright
            if mode == 1 and do_contrast:
                img *= alpha
            # float32 HSV as mmdet: H in [0, 360), S in [0, 1], V on the
            # input's 0-255 scale
            if do_sat or do_hue:
                hsv = cv2.cvtColor(np.clip(img, 0, 255), cv2.COLOR_RGB2HSV)
                if do_sat:
                    hsv[..., 1] *= sat
                if do_hue:
                    hsv[..., 0] += hue
                    hsv[..., 0][hsv[..., 0] > 360] -= 360
                    hsv[..., 0][hsv[..., 0] < 0] += 360
                img = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
            if mode == 0 and do_contrast:
                img *= alpha
            if do_swap:
                img = img[..., perm]
            return img

        results["imgs"] = [distort(img) for img in results["imgs"]]
        return results


class KeypointRandomAffine:
    """One random warp (rotation, scale, shear, translation) shared by all
    frames; boxes and keypoints follow it, joints that leave the image are
    zeroed and people left without a joint dropped (the sample too, when
    nobody is left)."""

    def __init__(self, max_rotate_degree=30.0, max_translate_ratio=0.0,
                 scaling_ratio_range=(1.0, 1.0), max_shear_degree=0.0,
                 border_val=(123.675, 116.28, 103.53)):
        self.max_rotate_degree = max_rotate_degree
        self.max_translate_ratio = max_translate_ratio
        self.scaling_ratio_range = scaling_ratio_range
        self.max_shear_degree = max_shear_degree
        self.border_val = tuple(border_val)

    def _warp_matrix(self, h, w, r):
        center = np.eye(3, dtype=np.float32)
        center[0, 2] = -w / 2
        center[1, 2] = -h / 2
        rad = math.radians(
            r.uniform(-self.max_rotate_degree, self.max_rotate_degree))
        rot = np.array([[math.cos(rad), -math.sin(rad), 0],
                        [math.sin(rad), math.cos(rad), 0],
                        [0, 0, 1]], np.float32)
        s = r.uniform(*self.scaling_ratio_range)
        scale = np.diag([s, s, 1]).astype(np.float32)
        sx = math.tan(math.radians(r.uniform(
            -self.max_shear_degree, self.max_shear_degree)))
        sy = math.tan(math.radians(r.uniform(
            -self.max_shear_degree, self.max_shear_degree)))
        shear = np.array([[1, sx, 0], [sy, 1, 0], [0, 0, 1]], np.float32)
        tx = r.uniform(0.5 - self.max_translate_ratio,
                       0.5 + self.max_translate_ratio) * w
        ty = r.uniform(0.5 - self.max_translate_ratio,
                       0.5 + self.max_translate_ratio) * h
        trans = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float32)
        return trans @ shear @ rot @ scale @ center

    def __call__(self, results, rng=None):
        h, w = results["imgs"][0].shape[:2]
        m = self._warp_matrix(h, w, _need(rng, "KeypointRandomAffine").py)
        results["imgs"] = [
            cv2.warpPerspective(img, m, dsize=(w, h),
                                borderValue=self.border_val)
            for img in results["imgs"]]

        kpts = results["gt_keypoints"]
        bboxes = results["gt_bboxes"]
        G = len(kpts)
        if G:
            # boxes: warp the 4 corners, take the envelope, clip
            xs = bboxes[:, [0, 0, 2, 2]].reshape(-1)
            ys = bboxes[:, [1, 3, 3, 1]].reshape(-1)
            pts = m @ np.vstack([xs, ys, np.ones_like(xs)])
            pts = pts[:2] / pts[2]
            xs = pts[0].reshape(G, 4)
            ys = pts[1].reshape(G, 4)
            bboxes = np.stack([xs.min(1).clip(0, w), ys.min(1).clip(0, h),
                               xs.max(1).clip(0, w), ys.max(1).clip(0, h)],
                              1).astype(np.float32)
            kxy = kpts[..., :2].reshape(-1, 2)
            pts = m @ np.vstack([kxy[:, 0], kxy[:, 1],
                                 np.ones(len(kxy))]).astype(np.float32)
            kxy = (pts[:2] / pts[2]).T.reshape(G, -1, 2)
            kpts = np.concatenate([kxy, kpts[..., 2:]], -1)
            invalid = ((kpts[..., 0] < 0) | (kpts[..., 1] < 0)
                       | (kpts[..., 0] > w) | (kpts[..., 1] > h)
                       | (kpts[..., 2] < 0.1))
            keep = ~invalid.all(1)
            kpts[invalid] = 0
            if not keep.any():
                return None
            results["gt_keypoints"] = kpts[keep].astype(np.float32)
            results["gt_bboxes"] = bboxes[keep]
            results["gt_areas"] = results["gt_areas"][keep]
            results["gt_labels"] = results["gt_labels"][keep]
        return results


class RandomFlip:
    """Horizontal flip of every frame with probability ``flip_ratio``, left
    and right keypoints swapped by ``flip_pairs``."""

    def __init__(self, flip_ratio=0.5):
        self.flip_ratio = flip_ratio

    def __call__(self, results, rng=None):
        if _need(rng, "RandomFlip").py.random() >= self.flip_ratio:
            return results
        w = results["imgs"][0].shape[1]
        results["imgs"] = [np.ascontiguousarray(img[:, ::-1])
                           for img in results["imgs"]]
        kpts = results["gt_keypoints"]
        if len(kpts):
            kpts = kpts.copy()
            vis = kpts[..., 2] > 0
            kpts[..., 0] = np.where(vis, w - kpts[..., 0], kpts[..., 0])
            for a, b in results.get("flip_pairs", ()):
                kpts[:, [a, b]] = kpts[:, [b, a]]
            results["gt_keypoints"] = kpts
            bboxes = results["gt_bboxes"].copy()
            bboxes[:, [0, 2]] = w - bboxes[:, [2, 0]]
            results["gt_bboxes"] = bboxes
        results["flipped"] = True
        return results


class Resize:
    """Keep-ratio resize to a ``(long, short)`` cap, mm-style.

    ``img_scale``: one ``(long, short)`` or a list of them; with several,
    ``multiscale_mode`` 'range' draws each edge between the first two and
    'value' picks one. Keypoints, boxes and areas are scaled with the image.
    """

    def __init__(self, img_scale, multiscale_mode="range", keep_ratio=True):
        if isinstance(img_scale[0], (int, float)):
            img_scale = [img_scale]
        self.img_scales = [tuple(s) for s in img_scale]
        self.multiscale_mode = multiscale_mode
        self.keep_ratio = keep_ratio

    def _pick_scale(self, rng):
        if len(self.img_scales) == 1:
            return self.img_scales[0]
        r = _need(rng, "Resize with several scales").py
        if self.multiscale_mode == "value":
            return r.choice(self.img_scales)
        a, b = self.img_scales[0], self.img_scales[1]
        long_edge = r.randint(min(a[0], b[0]), max(a[0], b[0]))
        short_edge = r.randint(min(a[1], b[1]), max(a[1], b[1]))
        return (long_edge, short_edge)

    def __call__(self, results, rng=None):
        long_cap, short_cap = self._pick_scale(rng)
        h, w = results["imgs"][0].shape[:2]
        sf = min(max(long_cap, short_cap) / max(h, w),
                 min(long_cap, short_cap) / min(h, w))
        new_w, new_h = int(w * sf + 0.5), int(h * sf + 0.5)
        if (new_w, new_h) != (w, h):
            results["imgs"] = [
                cv2.resize(img, (new_w, new_h),
                           interpolation=cv2.INTER_LINEAR)
                for img in results["imgs"]]
        w_scale = new_w / w
        h_scale = new_h / h
        results["img_shape"] = (new_h, new_w)
        results["scale_factor"] = results.get(
            "scale_factor", np.ones(2, np.float32)) * np.array(
                [w_scale, h_scale], np.float32)
        kpts = results.get("gt_keypoints")
        if kpts is not None and len(kpts):
            kpts = kpts.copy()
            kpts[..., 0] *= w_scale
            kpts[..., 1] *= h_scale
            results["gt_keypoints"] = kpts
            results["gt_bboxes"] = results["gt_bboxes"] * np.array(
                [w_scale, h_scale, w_scale, h_scale], np.float32)
            results["gt_areas"] = results["gt_areas"] * w_scale * h_scale
        return results


class RandomCrop:
    """A crop shared by all frames: 'absolute_range' draws its height and
    width from ``crop_size``, otherwise ``crop_size`` is (h, w)."""

    def __init__(self, crop_size=(384, 600), crop_type="absolute_range",
                 allow_negative_crop=True):
        self.crop_size = crop_size
        self.crop_type = crop_type
        self.allow_negative_crop = allow_negative_crop

    def __call__(self, results, rng=None):
        r = _need(rng, "RandomCrop").py
        h, w = results["imgs"][0].shape[:2]
        if self.crop_type == "absolute_range":
            ch = min(h, r.randint(self.crop_size[0], self.crop_size[1]))
            cw = min(w, r.randint(self.crop_size[0], self.crop_size[1]))
        else:
            ch, cw = min(h, self.crop_size[0]), min(w, self.crop_size[1])
        y0 = r.randint(0, h - ch)
        x0 = r.randint(0, w - cw)
        results["imgs"] = [img[y0:y0 + ch, x0:x0 + cw].copy()
                           for img in results["imgs"]]
        results["img_shape"] = (ch, cw)

        kpts = results["gt_keypoints"]
        if len(kpts):
            kpts = kpts.copy()
            kpts[..., 0] -= x0
            kpts[..., 1] -= y0
            invalid = ((kpts[..., 0] < 0) | (kpts[..., 1] < 0)
                       | (kpts[..., 0] > cw) | (kpts[..., 1] > ch)
                       | (kpts[..., 2] < 0.1))
            keep = ~invalid.all(1)
            kpts[invalid] = 0
            if not keep.any() and not self.allow_negative_crop:
                return None
            bboxes = results["gt_bboxes"] - np.array(
                [x0, y0, x0, y0], np.float32)
            bboxes[:, [0, 2]] = bboxes[:, [0, 2]].clip(0, cw)
            bboxes[:, [1, 3]] = bboxes[:, [1, 3]].clip(0, ch)
            results["gt_keypoints"] = kpts[keep]
            results["gt_bboxes"] = bboxes[keep]
            results["gt_areas"] = results["gt_areas"][keep]
            results["gt_labels"] = results["gt_labels"][keep]
        return results


class Normalize:
    def __init__(self, mean=(123.675, 116.28, 103.53),
                 std=(58.395, 57.12, 57.375)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, results, rng=None):
        results["imgs"] = [(img - self.mean) / self.std
                           for img in results["imgs"]]
        return results


DEFAULT_BUCKETS = ((256, 448), (384, 640), (512, 896), (640, 1088),
                   (736, 1280), (800, 1344), (896, 1472), (1024, 1664),
                   (1216, 1216), (1344, 1344))


class PadToBucket:
    """Pad bottom/right with zeros to the smallest static (H, W) bucket
    that fits; the model masks the padding from ``img_shape``."""

    def __init__(self, buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS):
        self.buckets = sorted(buckets, key=lambda b: b[0] * b[1])

    def __call__(self, results, rng=None):
        h, w = results["imgs"][0].shape[:2]
        for bh, bw in self.buckets:
            if bh >= h and bw >= w:
                break
        else:
            raise ValueError(f"image {h}x{w} exceeds all buckets")
        results["imgs"] = [
            np.pad(img, ((0, bh - h), (0, bw - w), (0, 0)))
            for img in results["imgs"]]
        results["pad_shape"] = (bh, bw)
        return results


class FormatBatch:
    """Stack the frames into the model's per-sample arrays: ``img (T, H, W,
    3)`` float32, ``img_shape (2,)`` int32, ``scale_factor (2,)`` float32,
    ``image_id``, and the GT where present.

    ``keep_dtype``: leave the image in the chain's dtype (uint8 for the test
    chain normalised on the card). ``cast_uint8``: round and clip a float
    0-255 image to uint8 (the train chain normalised on the card:
    augmentation runs in float, the batch crosses to the card at a quarter
    of the bytes; the rounding is at most 0.5/58 in normalised units)."""

    def __init__(self, keep_dtype: bool = False, cast_uint8: bool = False):
        self.keep_dtype = keep_dtype
        self.cast_uint8 = cast_uint8

    def __call__(self, results, rng=None):
        imgs = np.stack(results["imgs"], 0)
        if self.cast_uint8 and imgs.dtype != np.uint8:
            imgs = np.clip(np.round(imgs), 0, 255).astype(np.uint8)
        out = dict(
            img=imgs if (self.keep_dtype or self.cast_uint8)
            else imgs.astype(np.float32),
            img_shape=np.asarray(results["img_shape"], np.int32),
            scale_factor=np.asarray(results["scale_factor"], np.float32),
            image_id=results.get("image_id", -1),
        )
        if "gt_keypoints" in results:
            out.update(
                gt_keypoints=results["gt_keypoints"].astype(np.float32),
                gt_areas=results["gt_areas"].astype(np.float32),
                gt_labels=results["gt_labels"].astype(np.int64),
            )
            if "gt_bboxes" in results:
                out["gt_bboxes"] = results["gt_bboxes"].astype(np.float32)
        return out


def build_train_pipeline(img_norm_mean=(123.675, 116.28, 103.53),
                         img_norm_std=(58.395, 57.12, 57.375),
                         max_rotate_degree=30.0,
                         flip_ratio=0.5,
                         scale_range=((400, 1200), (1200, 1200)),
                         photometric=True,
                         buckets=DEFAULT_BUCKETS,
                         normalize_on_device=False) -> Compose:
    """The train chain: load, photometric distortion, shared affine, flip,
    multi-scale resize, normalise, bucket pad, format.

    ``normalize_on_device``: augmentation still runs in float 0-255, the
    host Normalize is left out and the batch is rounded to uint8;
    ``apis/prep.py`` normalises it on the card and zeroes the padding."""
    steps = [LoadClip()]
    if photometric:
        steps.append(PhotoMetricDistortion())
    steps += [
        KeypointRandomAffine(max_rotate_degree=max_rotate_degree,
                             border_val=img_norm_mean),
        RandomFlip(flip_ratio),
        Resize(list(scale_range), multiscale_mode="range"),
    ]
    if normalize_on_device:
        return Compose(steps + [PadToBucket(buckets),
                                FormatBatch(cast_uint8=True)])
    return Compose(steps + [Normalize(img_norm_mean, img_norm_std),
                            PadToBucket(buckets), FormatBatch()])


def build_test_pipeline(img_scale=(1333, 800),
                        img_norm_mean=(123.675, 116.28, 103.53),
                        img_norm_std=(58.395, 57.12, 57.375),
                        buckets=DEFAULT_BUCKETS,
                        loadclip_cache=16,
                        normalize_on_device=False) -> Compose:
    """The test chain: load (decode cache on: consecutive clips share
    frames), single-scale resize, normalise, bucket pad, format.

    ``normalize_on_device``: uint8 from end to end on the host (cv2 resizes
    uint8 natively); ``apis/prep.py`` normalises on the card."""
    if normalize_on_device:
        return Compose([
            LoadClip(cache_size=loadclip_cache, dtype=np.uint8),
            Resize([img_scale], multiscale_mode="value"),
            PadToBucket(buckets),
            FormatBatch(keep_dtype=True),
        ])
    return Compose([
        LoadClip(cache_size=loadclip_cache),
        Resize([img_scale], multiscale_mode="value"),
        Normalize(img_norm_mean, img_norm_std),
        PadToBucket(buckets),
        FormatBatch(),
    ])
