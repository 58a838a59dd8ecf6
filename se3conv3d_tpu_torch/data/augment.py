"""Point-cloud augmentation pipeline (host-side, numpy, pure functions),
copied from ``se3conv3d_tpu/data/augment.py`` so the port imports nothing of
the JAX package; the same generator gives the same bits in both.

Counterparts of the 12 ``Augmentation`` subclasses and ``AugPipeline`` of
the reference (``point_cloud_lib/augment/``).  Augmentation runs on the
host inside the data pipeline, so these are numpy functions taking an
explicit ``np.random.Generator``; the constructor keyword names match the
reference's (``p_prob``, ``p_axes``, ...) so the shipped aug-config modules
(``configs/*/*_Aug*.py``) load verbatim.

Each augmentation maps ``(rng, pts, extras) -> (pts, params, extras)``
where ``extras`` is a list of per-point tensors that follow the points
(colors, normals, labels, ids) gated by ``p_apply_extra_tensors`` — the
reference's extra-tensor protocol (``augment/Augmentation.py:7-50``).
Crop-style augs instead subset rows of *all* extras (they change N).

``ElasticDistortionAug`` and ``CropPtsAug`` call the native library
(``native/``) where it loads; ``CropPtsAug``'s native selection keeps the
points its numpy sort keeps.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "Augmentation",
    "CenterAug",
    "CropBoxAug",
    "CropPtsAug",
    "DropAug",
    "ElasticDistortionAug",
    "LinearAug",
    "MirrorAug",
    "NoiseAug",
    "RotationAug",
    "RotationAug3D",
    "STDDevNormAug",
    "TranslationAug",
    "AugPipeline",
]


def _axis_rotation(axis: int, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    if axis == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    if axis == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    if axis == 2:
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    raise ValueError(f"axis must be 0, 1 or 2, got {axis}")


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    """Uniform SO(3) rotation via a normalised quaternion (same
    distribution as reference ``pc/RotationFunctions.py:176-233``)."""
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


class Augmentation:
    """Base class; mirrors reference ``augment/Augmentation.py``."""

    def __init__(self, p_prob=1.0, p_apply_extra_tensors=(), **kwargs):
        self.prob_ = p_prob
        self.apply_extra_tensors_ = list(p_apply_extra_tensors)
        self.epoch_iter_ = 0

    # epoch counter: deterministic test-time-augmentation schedules
    # (reference ``test_dfaust_rot.py:309``).
    def increase_epoch_counter(self):
        self.epoch_iter_ += 1

    def reset_epoch_counter(self):
        self.epoch_iter_ = 0

    def _map_extras(self, extras, fn):
        out = []
        for i, t in enumerate(extras):
            apply = (
                self.apply_extra_tensors_[i]
                if i < len(self.apply_extra_tensors_)
                else False
            )
            out.append(fn(t) if apply else t)
        return out

    def _subset_extras(self, extras, mask):
        """Row-subset of every extra (crop semantics, reference
        ``CropPtsAug``/``CropBoxAug``)."""
        out = []
        for i, t in enumerate(extras):
            apply = (
                self.apply_extra_tensors_[i]
                if i < len(self.apply_extra_tensors_)
                else False
            )
            out.append(t[mask] if apply else t)
        return out

    def __call__(self, rng, pts, extras):
        raise NotImplementedError


class CenterAug(Augmentation):
    """Subtract the mean/max/min along the enabled axes
    (reference ``CenterAug.py``; always applied, prob 1)."""

    def __init__(self, p_axes=(True, True, True), p_method="mean", **kw):
        # always applied: a configured p_prob is swallowed, exactly like
        # the reference constructor (CenterAug.py:24 forces 1.0)
        kw.pop("p_prob", None)
        super().__init__(p_prob=1.0, **kw)
        self.axes_ = np.asarray(p_axes, bool)
        self.method_ = p_method

    def __call__(self, rng, pts, extras):
        if self.method_ == "mean":
            c = pts.mean(0)
        elif self.method_ == "max":
            c = pts.max(0)
        elif self.method_ == "min":
            c = pts.min(0)
        else:
            raise ValueError(self.method_)
        c = np.where(self.axes_, c, 0.0).astype(pts.dtype)
        return pts - c, (c,), self._map_extras(extras, lambda t: t - c)


class RotationAug(Augmentation):
    """Rotation about a fixed axis, random angle in [min, max] or a
    per-epoch angle schedule (reference ``RotationAug.py``).  Points are
    row vectors: ``pts @ R``."""

    def __init__(self, p_axis=0, p_min_angle=0.0, p_max_angle=2 * np.pi,
                 p_angle_values=None, **kw):
        super().__init__(**kw)
        self.axis_ = p_axis
        self.min_angle_ = p_min_angle
        self.max_angle_ = p_max_angle
        self.angle_values_ = p_angle_values

    def __call__(self, rng, pts, extras):
        if self.angle_values_ is None:
            ang = rng.uniform(self.min_angle_, self.max_angle_)
        else:
            ang = self.angle_values_[self.epoch_iter_]
        r = _axis_rotation(self.axis_, ang)
        return (
            pts @ r,
            (self.axis_, ang),
            self._map_extras(extras, lambda t: t @ r),
        )


class RotationAug3D(Augmentation):
    """Uniform SO(3) rotation, or a random planar rotation about
    ``p_axis`` (reference ``RotationAug3D.py``)."""

    def __init__(self, p_axis=None, **kw):
        super().__init__(**kw)
        self.axis_ = p_axis

    def __call__(self, rng, pts, extras):
        if self.axis_ is None:
            r = _random_rotation(rng)
        else:
            r = _axis_rotation(self.axis_, rng.uniform(0.0, 2 * np.pi))
        return pts @ r, (r,), self._map_extras(extras, lambda t: t @ r)


class MirrorAug(Augmentation):
    """Per-axis random sign flip gated by ``p_axes``
    (reference ``MirrorAug.py``)."""

    def __init__(self, p_mirror_prob=0.5, p_axes=(True, True, False), **kw):
        super().__init__(**kw)
        self.mirror_prob_ = p_mirror_prob
        self.axes_ = np.asarray(p_axes, bool)

    def __call__(self, rng, pts, extras):
        # Reference quirk preserved: flips when rand > mirror_prob.
        flip = (rng.random(pts.shape[-1]) > self.mirror_prob_) & self.axes_
        vec = np.where(flip, -1.0, 1.0).astype(pts.dtype)
        return pts * vec, (vec,), self._map_extras(extras, lambda t: t * vec)


class NoiseAug(Augmentation):
    """Additive gaussian noise with optional clipping
    (reference ``NoiseAug.py``)."""

    def __init__(self, p_stddev=0.005, p_clip=None, **kw):
        super().__init__(**kw)
        self.stddev_ = p_stddev
        self.clip_ = p_clip

    def __call__(self, rng, pts, extras):
        noise = rng.standard_normal(pts.shape).astype(pts.dtype) * self.stddev_
        if self.clip_ is not None:
            noise = np.clip(noise, -self.clip_, self.clip_)
        # Reference quirk preserved: extras get noise*stddev again.
        return (
            pts + noise,
            (noise,),
            self._map_extras(extras, lambda t: t + noise * self.stddev_),
        )


class LinearAug(Augmentation):
    """y = a*x + b with random or per-epoch (a, b)
    (reference ``LinearAug.py``)."""

    def __init__(self, p_min_a=0.9, p_max_a=1.1, p_min_b=-0.1, p_max_b=0.1,
                 p_a_values=None, p_b_values=None, p_channel_independent=False,
                 **kw):
        super().__init__(**kw)
        self.min_a_, self.max_a_ = p_min_a, p_max_a
        self.min_b_, self.max_b_ = p_min_b, p_max_b
        self.a_values_, self.b_values_ = p_a_values, p_b_values
        self.channel_independent_ = p_channel_independent

    def __call__(self, rng, pts, extras):
        if self.a_values_ is None:
            shape = 1 if self.channel_independent_ else pts.shape[-1]
            a = rng.random(shape) * (self.max_a_ - self.min_a_) + self.min_a_
            b = rng.random(shape) * (self.max_b_ - self.min_b_) + self.min_b_
        else:
            a = np.asarray(self.a_values_[self.epoch_iter_])
            b = np.asarray(self.b_values_[self.epoch_iter_])
        a = a.astype(pts.dtype).reshape(1, -1)
        b = b.astype(pts.dtype).reshape(1, -1)
        return pts * a + b, (a, b), self._map_extras(extras, lambda t: t * a + b)


class TranslationAug(Augmentation):
    """Shift by a random fraction of the AABB half-extent
    (reference ``TranslationAug.py``)."""

    def __init__(self, p_max_aabb_ratio=1.0, **kw):
        super().__init__(**kw)
        self.max_aabb_ratio_ = p_max_aabb_ratio

    def __call__(self, rng, pts, extras):
        t = (rng.random(pts.shape[-1]) * 2.0 - 1.0) * self.max_aabb_ratio_
        disp = ((pts.max(0) - pts.min(0)) / 2.0 * t).astype(pts.dtype)
        return pts + disp, (disp,), self._map_extras(extras, lambda x: x + disp)


class STDDevNormAug(Augmentation):
    """Rescale to a target max-channel stddev (always applied;
    reference ``STDDevNormAug.py``)."""

    def __init__(self, p_new_std=1.0, **kw):
        kw.pop("p_prob", None)  # always applied (reference STDDevNormAug)
        super().__init__(p_prob=1.0, **kw)
        self.stddev_ = p_new_std

    def __call__(self, rng, pts, extras):
        prev = pts.std(0, ddof=1).max()
        scale = self.stddev_ / prev
        return (
            pts * scale,
            (prev, self.stddev_),
            self._map_extras(extras, lambda t: t * scale),
        )


class DropAug(Augmentation):
    """Random point dropout: zero-out (keep_zeros, reference sets dropped
    rows to 1.0) or row removal (reference ``DropAug.py``)."""

    def __init__(self, p_drop_prob=0.05, p_keep_zeros=True, **kw):
        super().__init__(**kw)
        self.drop_prob_ = p_drop_prob
        self.keep_zeros_ = p_keep_zeros

    def __call__(self, rng, pts, extras):
        keep = rng.random(pts.shape[0]) > self.drop_prob_
        if self.keep_zeros_:
            kf = keep.astype(pts.dtype)

            def fn(t):
                # broadcast against t's rank: an [N,1] mask on a 1-D
                # extra (labels/segments) would silently explode to
                # [N,N] (reference fills dropped rows with 1)
                m = kf.reshape((-1,) + (1,) * (t.ndim - 1)).astype(t.dtype)
                return t * m + (1 - m)

            return fn(pts), (keep,), self._map_extras(extras, fn)
        return pts[keep], (keep,), self._subset_extras(extras, keep)


class CropPtsAug(Augmentation):
    """Keep the ``max_pts`` (and/or crop_ratio fraction) nearest points
    around a random seed point (reference ``CropPtsAug.py``)."""

    def __init__(self, p_max_pts=0, p_crop_ratio=1.0, **kw):
        super().__init__(**kw)
        self.max_pts_ = p_max_pts
        self.crop_ratio_ = p_crop_ratio

    def __call__(self, rng, pts, extras):
        n = pts.shape[0]
        max_pts = self.max_pts_ if self.max_pts_ > 0 else n
        max_pts = min(max_pts, int(n * self.crop_ratio_))
        keep = np.ones(n, bool)
        if n > max_pts:
            seed = rng.integers(0, n)
            d2 = ((pts - pts[seed]) ** 2).sum(1)
            # native selection where the cut is free of ties, else the sort
            from ..native import select_nearest

            selected = select_nearest(d2, max_pts) if d2.dtype == np.float32 else None
            if selected is not None:
                keep = selected
            else:
                order = np.argsort(d2)
                keep[order[max_pts:]] = False
            return pts[keep], (keep,), self._subset_extras(extras, keep)
        return pts, (keep,), extras


class CropBoxAug(Augmentation):
    """Random axis-aligned box crop, retried until non-empty
    (reference ``CropBoxAug.py``)."""

    def __init__(self, p_min_crop_size=0.5, p_max_crop_size=1.0, **kw):
        super().__init__(**kw)
        self.min_crop_size_ = p_min_crop_size
        self.max_crop_size_ = p_max_crop_size

    def __call__(self, rng, pts, extras):
        mn, mx = pts.min(0), pts.max(0)
        size = mx - mn
        while True:
            crop = rng.random(pts.shape[-1]) * (
                self.max_crop_size_ - self.min_crop_size_
            ) + self.min_crop_size_
            crop = np.minimum(crop, size)
            origin = rng.random(pts.shape[-1]) * (mx - crop - mn) + mn
            keep = np.all((pts >= origin) & (pts <= origin + crop), axis=1)
            if keep.any():
                break
        return pts[keep], (keep, origin, crop), self._subset_extras(extras, keep)


class ElasticDistortionAug(Augmentation):
    """Elastic distortion: blurred random displacement grids trilinearly
    interpolated at the points (reference ``ElasticDistortionAug.py``,
    Minkowski-style)."""

    def __init__(self, p_granularity=(0.1,), p_magnitude=(0.2,), **kw):
        super().__init__(**kw)
        self.granularity_ = list(p_granularity)
        self.magnitude_ = list(p_magnitude)

    @staticmethod
    def _blur(noise):
        """Two passes of an axis-separable 3-tap box blur over [3,X,Y,Z]."""
        k = np.ones(3) / 3.0
        for _ in range(2):
            for ax in (1, 2, 3):
                noise = np.apply_along_axis(
                    lambda v: np.convolve(v, k, mode="same"), ax, noise
                )
        return noise

    @staticmethod
    def _trilinear(grid, coords01):
        """Sample [3,X,Y,Z] at normalized coords [N,3] (align_corners=True,
        border padding)."""
        dims = np.asarray(grid.shape[1:])
        pos = coords01 * (dims - 1)
        pos = np.clip(pos, 0, dims - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, dims - 1)
        w = pos - lo
        out = np.zeros((coords01.shape[0], 3), grid.dtype)
        for dx, wx in ((0, 1 - w[:, 0]), (1, w[:, 0])):
            ix = np.where(dx == 0, lo[:, 0], hi[:, 0])
            for dy, wy in ((0, 1 - w[:, 1]), (1, w[:, 1])):
                iy = np.where(dy == 0, lo[:, 1], hi[:, 1])
                for dz, wz in ((0, 1 - w[:, 2]), (1, w[:, 2])):
                    iz = np.where(dz == 0, lo[:, 2], hi[:, 2])
                    out += (wx * wy * wz)[:, None] * grid[:, ix, iy, iz].T
        return out

    def __call__(self, rng, pts, extras):
        # Fast path: the native C++ implementation (same blurred-grid +
        # trilinear math); falls back to numpy when the library is absent.
        from ..native import elastic_distortion as native_elastic

        out = native_elastic(
            pts, self.granularity_, self.magnitude_,
            seed=int(rng.integers(1 << 62)),
        )
        if out is not None:
            return out.astype(pts.dtype), (), extras

        coords = pts.astype(np.float64).copy()
        mn, mx = coords.min(0), coords.max(0)
        full = (coords - mn).max(0)
        for gran, mag in zip(self.granularity_, self.magnitude_):
            dims = (full // gran).astype(np.int32) + 3
            noise = rng.standard_normal((3, *dims))
            noise = self._blur(noise)
            u = (coords - mn) / np.maximum(mx - mn, 1e-12)
            coords += self._trilinear(noise, u) * mag
        return coords.astype(pts.dtype), (), extras


class AugPipeline:
    """Sequential pipeline built from config dicts
    (reference ``augment/AugPipeline.py:8-67``)."""

    _REGISTRY = {
        c.__name__: c
        for c in (
            CenterAug, CropBoxAug, CropPtsAug, DropAug, ElasticDistortionAug,
            LinearAug, MirrorAug, NoiseAug, RotationAug, RotationAug3D,
            STDDevNormAug, TranslationAug,
        )
    }

    def __init__(self, aug_dicts=()):
        self.pipeline_ = [
            self._REGISTRY[d["name"]](**{k: v for k, v in d.items() if k != "name"})
            for d in aug_dicts
        ]

    def increase_epoch_counter(self):
        for a in self.pipeline_:
            a.increase_epoch_counter()

    def reset_epoch_counter(self):
        for a in self.pipeline_:
            a.reset_epoch_counter()

    def augment(self, rng: np.random.Generator, pts, extras=()):
        """Apply each augmentation with its probability; returns
        ``(pts, [(name, params)], extras)``."""
        extras = list(extras)
        params = []
        for aug in self.pipeline_:
            if rng.random() <= aug.prob_:
                pts, p, extras = aug(rng, pts, extras)
                params.append((aug.__class__.__name__, p))
        return pts, params, extras
