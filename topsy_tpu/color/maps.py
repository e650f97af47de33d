"""Colormap family: raw SPH maps -> display images.

Reproduces the behaviour of the reference colormap classes (reference:
src/topsy/colormap/implementation.py and shaders/colormap.wgsl) with jnp
array ops instead of a fragment shader: log/linear scaling, 1-D LUT lookup,
bivariate 2-D LUT, RGB gamma/magnitude tonemaps, percentile autoranging, and
the photometric mass-scale compensation applied to vmin/vmax for partial
progressive renders (reference: implementation.py:427-453).

Parameter-dict dispatch semantics (``accepts_parameters`` over the subclass
tree) are identical, so mode switching behaves the same way.
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..util import require

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# jnp mapping primitives
# ---------------------------------------------------------------------------

def _log10(x):
    return jnp.log(x) / 2.30258509


# ---------------------------------------------------------------------------
# jitted mapping kernels (compiled once per static mode; interactive frames
# then cost one dispatch instead of dozens of eager ops)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("log", "weighted"))
def _map_univariate(raw, lut, vmin, vmax, *, log, weighted):
    value = raw[..., 1] / raw[..., 0] if weighted else raw[..., 0]
    if log:
        value = _log10(value)
    norm = jnp.clip((value - vmin) / (vmax - vmin), 0.0, 1.0)
    norm = jnp.where(jnp.isfinite(norm), norm, 0.0)
    return sample_lut_1d(norm, lut)


@functools.partial(jax.jit, static_argnames=("log", "clip"))
def _map_rgb(raw, vmin, vmax, gamma, *, log, clip):
    value = _log10(raw) if log else raw
    norm = jnp.maximum((value - vmin) / (vmax - vmin), 0.0)
    norm = jnp.where(jnp.isfinite(norm), norm, 0.0)
    mapped = norm ** gamma
    if clip:
        mapped = jnp.clip(mapped, 0.0, 1.0)
    alpha = jnp.ones_like(mapped[..., :1])
    return jnp.concatenate([mapped, alpha], axis=-1)


@functools.partial(jax.jit, static_argnames=("log", "weighted"))
def _map_bivariate(raw, lut, vmin, vmax, dmin, dmax, *, log, weighted):
    den = _log10(raw[..., 0])
    u = (den - dmin) / (dmax - dmin)
    val = raw[..., 1] / raw[..., 0] if weighted else raw[..., 0]
    if log:
        val = _log10(val)
    v = (val - vmin) / (vmax - vmin)
    u = jnp.where(jnp.isfinite(u), u, 0.0)
    v = jnp.where(jnp.isfinite(v), v, 0.0)
    # LUT rows are colour (quantity), columns lightness (density)
    return sample_lut_2d(v, u, lut)


def colormap_rgba(name: str, x: np.ndarray) -> np.ndarray:
    """RGBA (float64, (..., 4)) of the colormap ``name`` at positions ``x``
    in [0, 1].  The default colormap comes from its vendored colour table
    (color/default_lut.py, the same lookup as matplotlib's ListedColormap);
    any other name is looked up in matplotlib."""
    from . import default_lut
    if name == default_lut.NAME:
        rgb = np.asarray(default_lut.RGB, dtype=np.float64)
        n = len(rgb)
        idx = np.clip((np.asarray(x, np.float64) * n).astype(int), 0, n - 1)
        return np.concatenate([rgb[idx], np.ones(idx.shape + (1,))], axis=-1)
    return require("matplotlib", f"colormap {name!r}").colormaps[name](x)


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) RGB in [0, 1] to HSV (matplotlib.colors.rgb_to_hsv)."""
    rgb = np.asarray(rgb)
    out = np.zeros_like(rgb)
    v = rgb.max(-1)
    delta = np.ptp(rgb, -1)
    s = np.zeros_like(delta)
    ipos = v > 0
    s[ipos] = delta[ipos] / v[ipos]
    ipos = delta > 0
    for c, (a, b) in enumerate(((1, 2), (2, 0), (0, 1))):
        idx = (rgb[..., c] == v) & ipos
        out[idx, 0] = 2.0 * c + (rgb[idx, a] - rgb[idx, b]) / delta[idx]
    out[..., 0] = (out[..., 0] / 6.0) % 1.0
    out[..., 1] = s
    out[..., 2] = v
    return out


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """(..., 3) HSV to RGB (matplotlib.colors.hsv_to_rgb)."""
    hsv = np.asarray(hsv)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    r, g, b = np.empty_like(h), np.empty_like(h), np.empty_like(h)
    for k, (rr, gg, bb) in enumerate(((v, t, p), (q, v, p), (p, v, t),
                                      (p, q, v), (t, p, v), (v, p, q))):
        idx = i % 6 == k
        r[idx], g[idx], b[idx] = rr[idx], gg[idx], bb[idx]
    idx = s == 0
    r[idx], g[idx], b[idx] = v[idx], v[idx], v[idx]
    return np.stack([r, g, b], axis=-1)


def sample_lut_1d(values: jnp.ndarray, lut: jnp.ndarray) -> jnp.ndarray:
    """Linear-interpolated 1-D LUT lookup; values already in [0, 1]."""
    n = lut.shape[0]
    x = jnp.clip(values, 0.0, 1.0) * (n - 1)
    i0 = jnp.clip(x.astype(jnp.int32), 0, n - 2)
    frac = (x - i0)[..., None]
    return lut[i0] * (1 - frac) + lut[i0 + 1] * frac


def sample_lut_2d(u: jnp.ndarray, v: jnp.ndarray, lut: jnp.ndarray) -> jnp.ndarray:
    """Bilinear 2-D LUT lookup; u indexes rows, v columns, both in [0, 1]."""
    n, m = lut.shape[0], lut.shape[1]
    x = jnp.clip(u, 0.0, 1.0) * (n - 1)
    y = jnp.clip(v, 0.0, 1.0) * (m - 1)
    i0 = jnp.clip(x.astype(jnp.int32), 0, n - 2)
    j0 = jnp.clip(y.astype(jnp.int32), 0, m - 2)
    fx = (x - i0)[..., None]
    fy = (y - j0)[..., None]
    v00 = lut[i0, j0]
    v01 = lut[i0, j0 + 1]
    v10 = lut[i0 + 1, j0]
    v11 = lut[i0 + 1, j0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * (1 - fx) * fy
            + v10 * fx * (1 - fy) + v11 * fx * fy)


@functools.partial(jax.jit, static_argnames=("width", "height"))
def fit_to_window(square: jnp.ndarray, width: int, height: int) -> jnp.ndarray:
    """Aspect-ratio central crop + resize of the square render onto a
    (height, width) window, matching the reference's quad stretch
    (reference: shaders/colormap.wgsl:50-58)."""
    s = square.shape[0]
    aspect = width / height
    if aspect >= 1.0:
        vis = max(2, int(round(s / aspect)))
        r0 = (s - vis) // 2
        cropped = square[r0:r0 + vis, :, :]
    else:
        vis = max(2, int(round(s * aspect)))
        c0 = (s - vis) // 2
        cropped = square[:, c0:c0 + vis, :]
    return jax.image.resize(cropped, (height, width, square.shape[2]),
                            method="linear", antialias=False)


# ---------------------------------------------------------------------------
# class family
# ---------------------------------------------------------------------------

#: Every concrete colormap class, in definition order.  Populated by
#: ``ColormapBase.__init_subclass__`` at class-creation time, so importing a
#: module that defines a colormap (e.g. color.surface) is what makes it
#: available to :func:`resolve_colormap_class` — no tree walking.
COLORMAP_REGISTRY: list[type["ColormapBase"]] = []


def resolve_colormap_class(parameters: dict) -> type["ColormapBase"] | None:
    """The registered class whose parameter domain contains ``parameters``.

    Domains (the ``accepts_parameters`` predicates) are disjoint by
    construction — each keys on a distinct ``type`` tag, with the rgb/hdr
    pair split on ``hdr`` — so at most one class matches."""
    for cls in COLORMAP_REGISTRY:
        if cls.accepts_parameters(parameters):
            return cls
    return None


class ColormapBase:
    _default_params: dict = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        COLORMAP_REGISTRY.append(cls)

    def __init__(self, params: dict):
        self._params = self._default_params | params

    @classmethod
    def accepts_parameters(cls, parameters: dict) -> bool:
        return False

    def update_parameters(self, parameters: dict):
        if not self.accepts_parameters(self._params | parameters):
            raise ValueError(
                f"{self.__class__.__name__} does not accept parameter update: {parameters}")
        self._params.update(parameters)

    def get_parameter(self, name: str):
        return self._params.get(name, None)

    def get_parameters(self) -> dict:
        return self._params.copy()

    # subclass contract -------------------------------------------------------
    def to_rgba(self, raw_image, mass_scale: float = 1.0) -> jnp.ndarray:
        """Map the raw SPH output to an RGBA float image (values 0..1+)."""
        raise NotImplementedError

    def sph_raw_output_to_content(self, numpy_image: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def autorange_vmin_vmax(self, vals: np.ndarray):
        raise NotImplementedError


class NoColormap(ColormapBase):
    """Placeholder before a mode is selected (reference: implementation.py:57-62)."""

    @classmethod
    def accepts_parameters(cls, parameters: dict) -> bool:
        return parameters.get("type", None) == "none"


class Colormap(ColormapBase):
    """Univariate density / weighted-average colormap."""

    input_channels = 2
    percentile_scaling = config.AUTORANGE_PERCENTILES
    may_produce_weighted_average = True

    _default_params = {"colormap_name": "viridis", "vmin": 0.0, "vmax": 1.0,
                       "log": True, "weighted_average": False}

    def __init__(self, params: dict):
        super().__init__(params)
        self._lut = None
        self._lut_for = None

    @classmethod
    def accepts_parameters(cls, parameters: dict) -> bool:
        return parameters.get("type", None) == "density"

    # -- LUT -------------------------------------------------------------------

    def _generate_mapping_rgba_f32(self, num_points: int) -> np.ndarray:
        name = self._params.get("colormap_name", config.DEFAULT_COLORMAP)
        return colormap_rgba(
            name, np.linspace(0.001, 0.999, num_points)).astype(np.float32)

    def lut(self) -> jnp.ndarray:
        name = self._params.get("colormap_name")
        if self._lut is None or self._lut_for != name:
            self._lut = jnp.asarray(
                self._generate_mapping_rgba_f32(config.COLORMAP_NUM_SAMPLES))
            self._lut_for = name
        return self._lut

    # -- content & mapping -------------------------------------------------------

    def sph_raw_output_to_content(self, numpy_image: np.ndarray) -> np.ndarray:
        """Drop/ratio channels to the logical content (reference:
        implementation.py:119-130)."""
        if self._params["weighted_average"]:
            # empty pixels divide 0/0 to NaN deliberately (masked downstream
            # by the colormap); keep numpy from warning about them
            with np.errstate(invalid="ignore", divide="ignore"):
                return numpy_image[..., 1] / numpy_image[..., 0]
        return numpy_image[..., 0]

    def _effective_vmin_vmax(self, mass_scale: float):
        """Shift vmin/vmax so partial progressive renders display correctly
        (reference: implementation.py:427-453)."""
        vmin, vmax = self._params["vmin"], self._params["vmax"]
        if self.may_produce_weighted_average and self._params.get("weighted_average", False):
            mass_scale = 1.0
        if self._params["log"]:
            shift = np.log10(mass_scale)
            return vmin - shift, vmax - shift
        return vmin / mass_scale, vmax / mass_scale

    def to_rgba(self, raw_image, mass_scale: float = 1.0) -> jnp.ndarray:
        vmin, vmax = self._effective_vmin_vmax(mass_scale)
        return _map_univariate(
            jnp.asarray(raw_image), self.lut(),
            jnp.float32(vmin), jnp.float32(vmax),
            log=bool(self._params["log"]),
            weighted=bool(self._params.get("weighted_average", False)))

    # -- autorange (reference: implementation.py:381-425) -------------------------

    @classmethod
    def _finite_range(cls, values):
        valid = np.isfinite(values)
        vv = values[valid]
        if len(vv) > 0:
            return np.min(vv), np.max(vv)
        return np.nan, np.nan

    def autorange_vmin_vmax(self, vals):
        if isinstance(vals, jnp.ndarray) and not isinstance(vals, np.ndarray):
            # keep the percentile on device (histogram + psum-replicated
            # framebuffer; only scalars cross the host boundary)
            content = self._raw_to_content_device(vals).ravel()
            self._autorange_using_values(content)
        else:
            self._autorange_using_values(
                self.sph_raw_output_to_content(np.asarray(vals)).ravel())

    def _raw_to_content_device(self, raw: jnp.ndarray) -> jnp.ndarray:
        if self._params["weighted_average"]:
            return raw[..., 1] / raw[..., 0]
        return raw[..., 0]

    def _autorange_using_values(self, vals):
        from ..ops import stats

        new_params = {}
        if isinstance(vals, jnp.ndarray) and not isinstance(vals, np.ndarray):
            lin_p, n_lin, vmin, vmax = stats.percentiles(
                vals, self.percentile_scaling)
            log_p, n_log, log_min, log_max = stats.percentiles(
                jnp.log10(vals), self.percentile_scaling)
            any_neg = bool(np.asarray((vals < 0).any()))
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                log_vals = np.log10(vals)
            log_min, log_max = self._finite_range(log_vals)
            vmin, vmax = self._finite_range(vals)
            any_neg = bool((vals < 0).any())
            lin_f = vals[np.isfinite(vals)]
            log_f = log_vals[np.isfinite(log_vals)]
            n_lin, n_log = len(lin_f), len(log_f)
            lin_p = (np.percentile(lin_f, self.percentile_scaling)
                     if n_lin > 200 else
                     np.array([lin_f.min(), lin_f.max()]) if n_lin > 2 else None)
            log_p = (np.percentile(log_f, self.percentile_scaling)
                     if n_log > 200 else
                     np.array([log_f.min(), log_f.max()]) if n_log > 2 else None)

        if log_max == log_min:
            log_max += 1.0
            log_min -= 1.0
        if vmax == vmin:
            vmax += 1.0
            vmin -= 1.0
        new_params["ui_range_linear"] = (vmin, vmax)
        new_params["ui_range_log"] = (log_min, log_max)
        new_params["log"] = not any_neg

        use_p, use_n = (log_p, n_log) if new_params["log"] else (lin_p, n_lin)
        if use_n > 2 and use_p is not None:
            self._params["vmin"], self._params["vmax"] = \
                float(use_p[0]), float(use_p[-1])
        else:
            logger.warning("Unable to autorange: too few finite values")
            self._params["vmin"], self._params["vmax"] = 0.0, 1.0
        self.update_parameters(new_params)
        logger.info("Autoscale: log=%s vmin=%.4g vmax=%.4g",
                    self._params["log"], self._params["vmin"], self._params["vmax"])


class RGBColormap(Colormap):
    """SSP 3-band rendering with magnitude/arcsec^2 parameterization
    (reference: implementation.py:456-539)."""

    input_channels = 3
    max_percentile = 99.9
    dynamic_range = 3.0
    may_produce_weighted_average = False

    _sterrad_to_arcsec2 = 2.3504430539466191e-11

    _default_params = {"vmin": 0.0, "vmax": 1.0, "log": True, "gamma": 1.0}

    @classmethod
    def accepts_parameters(cls, parameters: dict) -> bool:
        parameters = cls._default_params | parameters
        return (parameters.get("type", None) == "rgb"
                and not parameters.get("hdr", False) and parameters["log"])

    @classmethod
    def _log_output_to_mag_per_arcsec2(cls, val):
        if val is None:
            return None
        return -2.5 * (val + np.log10(cls._sterrad_to_arcsec2) - 4)  # +4: (10pc->kpc)^2

    @classmethod
    def _mag_per_arcsec2_to_log_output(cls, val):
        if val is None:
            return None
        return val / -2.5 + 4 - np.log10(cls._sterrad_to_arcsec2)

    def get_parameters(self) -> dict:
        params = super().get_parameters()
        params["min_mag"] = self._log_output_to_mag_per_arcsec2(params["vmax"])
        params["max_mag"] = self._log_output_to_mag_per_arcsec2(params["vmin"])
        return params

    def get_parameter(self, name: str):
        if name == "min_mag":
            return self._log_output_to_mag_per_arcsec2(super().get_parameter("vmax"))
        if name == "max_mag":
            return self._log_output_to_mag_per_arcsec2(super().get_parameter("vmin"))
        return super().get_parameter(name)

    def update_parameters(self, parameters: dict):
        parameters = dict(parameters)
        if "min_mag" in parameters:
            parameters["vmax"] = self._mag_per_arcsec2_to_log_output(
                parameters.pop("min_mag"))
        if "max_mag" in parameters:
            parameters["vmin"] = self._mag_per_arcsec2_to_log_output(
                parameters.pop("max_mag"))
        ColormapBase.update_parameters(self, parameters)

    def sph_raw_output_to_content(self, numpy_image: np.ndarray) -> np.ndarray:
        return numpy_image[..., :3]

    def to_rgba(self, raw_image, mass_scale: float = 1.0) -> jnp.ndarray:
        vmin, vmax = self._effective_vmin_vmax(mass_scale)
        gamma = self._params.get("gamma", 1.0) or 1.0
        return _map_rgb(jnp.asarray(raw_image)[..., :3],
                        jnp.float32(vmin), jnp.float32(vmax),
                        jnp.float32(gamma),
                        log=bool(self._params["log"]),
                        clip=not self.hdr_output())

    def hdr_output(self) -> bool:
        return False

    def autorange_vmin_vmax(self, vals):
        if isinstance(vals, jnp.ndarray) and not isinstance(vals, np.ndarray):
            # device histogram percentile (ops/stats.py) — only scalars
            # cross the host boundary, as the univariate path
            from ..ops import stats
            p, n, _lo, hi = stats.percentiles(jnp.log10(vals.ravel()),
                                              self.max_percentile)
            if n > 200:
                self._params["vmax"] = float(p[0])
            elif n > 2:
                self._params["vmax"] = float(hi)
            else:
                logger.warning("Unable to autorange RGB map")
                self._params["vmax"] = 1.0
        else:
            vals = np.asarray(vals).ravel()
            with np.errstate(divide="ignore", invalid="ignore"):
                vals = np.log10(vals)
            vals = vals[np.isfinite(vals)]
            if len(vals) > 200:
                self._params["vmax"] = float(
                    np.percentile(vals, self.max_percentile))
            elif len(vals) > 2:
                self._params["vmax"] = float(np.max(vals))
            else:
                logger.warning("Unable to autorange RGB map")
                self._params["vmax"] = 1.0
        self._params["vmin"] = self._params["vmax"] - self.dynamic_range
        logger.info("RGB autorange: vmin=%.4g vmax=%.4g",
                    self._params["vmin"], self._params["vmax"])


class RGBHDRColormap(RGBColormap):
    """HDR variant: wider percentile, SDR-equivalent dynamic range 2.5 dex,
    un-clipped output for float16 display (reference: implementation.py:543-550)."""

    max_percentile = 99.0
    dynamic_range = 2.5

    @classmethod
    def accepts_parameters(cls, parameters: dict) -> bool:
        parameters = cls._default_params | parameters
        return (parameters.get("type", None) == "rgb"
                and parameters.get("hdr", False) and parameters["log"])

    def hdr_output(self) -> bool:
        return True


class BivariateColormap(Colormap):
    """2-D LUT: hue from the quantity, lightness from density
    (reference: implementation.py:553-605)."""

    default_quantity_name = "rho"

    _default_params = Colormap._default_params | {
        "density_vmin": 0.0, "density_vmax": 1.0, "ui_range_density": (0.0, 1.0)}

    @classmethod
    def accepts_parameters(cls, parameters: dict) -> bool:
        return (parameters.get("type", None) == "bivariate"
                and not parameters.get("hdr", False))

    def _generate_mapping_rgba_f32(self, num_points: int) -> np.ndarray:
        rgba = np.ones((num_points, num_points, 4), dtype=np.float32)
        rgba[:, :, :] = colormap_rgba(
            self._params["colormap_name"],
            np.linspace(0.001, 0.999, num_points))[:, np.newaxis, :]
        hsv = rgb_to_hsv(rgba[..., :3])
        hsv[..., 2] = np.linspace(0.001, 0.999, num_points)[np.newaxis, :]
        reduce_saturation = np.ones(num_points)
        reduce_saturation[3 * num_points // 4:] = np.linspace(1.0, 0.0, num_points // 4)
        hsv[..., 1] *= reduce_saturation[np.newaxis, :]
        rgba[..., :3] = hsv_to_rgb(hsv)
        return rgba

    def sph_raw_output_to_content(self, numpy_image: np.ndarray) -> np.ndarray:
        ret = np.array(numpy_image)  # device arrays come through here too
        if self._params["weighted_average"]:
            ret[..., 1] /= ret[..., 0]
        else:
            ret[..., 1] = ret[..., 0]
        return ret

    def to_rgba(self, raw_image, mass_scale: float = 1.0) -> jnp.ndarray:
        vmin, vmax = self._effective_vmin_vmax(mass_scale)
        dmin = self._params.get("density_vmin", 0.0) or 0.0
        dmax = self._params.get("density_vmax", 1.0) or 1.0
        shift = np.log10(mass_scale)
        return _map_bivariate(jnp.asarray(raw_image), self.lut(),
                              jnp.float32(vmin), jnp.float32(vmax),
                              jnp.float32(dmin - shift),
                              jnp.float32(dmax - shift),
                              log=bool(self._params["log"]),
                              weighted=bool(self._params.get("weighted_average",
                                                             False)))

    def autorange_vmin_vmax(self, vals):
        if isinstance(vals, jnp.ndarray) and not isinstance(vals, np.ndarray):
            # device histogram percentiles for BOTH axes (ops/stats.py):
            # only scalars cross the host boundary — no full-framebuffer
            # np.percentile readback (reference host analogue:
            # implementation.py:381-425, 512-531)
            from ..ops import stats
            den = vals[..., 0].ravel()
            dp, dn, dlo, dhi = stats.percentiles(jnp.log10(den),
                                                 self.percentile_scaling)
            if dn > 2:
                density_vmin, density_vmax = float(dp[0]), float(dp[-1])
                density_ui = (dlo, dhi)
            else:
                density_vmin, density_vmax = 0.0, 1.0
                density_ui = (np.nan, np.nan)
            self.update_parameters({
                "density_vmin": density_vmin,
                "density_vmax": density_vmax,
                "ui_range_density": density_ui,
            })
            if self._params["weighted_average"]:
                content = vals[..., 1] / vals[..., 0]
            else:
                content = vals[..., 0]
            self._autorange_using_values(content.ravel())
            return
        vals = self.sph_raw_output_to_content(np.asarray(vals))
        with np.errstate(divide="ignore", invalid="ignore"):
            den_vals = np.log10(vals[..., 0].ravel())
        den_vals = den_vals[np.isfinite(den_vals)]
        if len(den_vals) > 2:
            density_vmin, density_vmax = np.percentile(den_vals, self.percentile_scaling)
        else:
            density_vmin, density_vmax = 0.0, 1.0
        density_ui = self._finite_range(den_vals)
        self.update_parameters({
            "density_vmin": density_vmin,
            "density_vmax": density_vmax,
            "ui_range_density": density_ui,
        })
        self._autorange_using_values(vals[..., 1].ravel())
