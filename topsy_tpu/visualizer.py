"""The Visualizer: orchestrator owning loader, store, renderer, colormap,
overlays and canvas.

Facade contract mirrors the reference visualizer (reference:
src/topsy/visualizer.py:31-601): ``draw / render_sph / invalidate / rotate /
reset_view / save / show / get_sph_image / get_presentation_image`` plus the
``rotation_matrix / position_offset / scale / quantity_name / render_mode``
properties, render-mode switching with revert-on-failure, and the on-screen
status line (fps, downsampling factor, geometry factor).
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager

import numpy as np

from . import canvas as canvas_module
from . import config
from .color import ColormapHolder
from .color import surface as color_surface  # noqa: F401 (registers the class)
from .color.maps import fit_to_window
from .drawreason import DrawReason
from .loaders import AbstractDataLoader, TestDataLoader
from .overlays.colorbar import ColorbarOverlay
from .overlays.line import Line, SimCube
from .overlays.scalebar import ScalebarOverlay
from .overlays.text import TextOverlay
from .render import periodic, sph, surface
from .render.store import ParticleStore
from .view_synchronizer import SynchronizationMixin

logger = logging.getLogger(__name__)

VALID_RENDER_MODES = ("univariate", "bivariate", "rgb", "rgb-hdr", "surface")


class VisualizerBase:
    colorbar_aspect_ratio = config.COLORBAR_ASPECT_RATIO
    show_status = True
    show_colorbar = True
    show_scalebar = True

    def __init__(self, data_loader_class=TestDataLoader, data_loader_args=(),
                 data_loader_kwargs=None, *,
                 render_resolution=config.DEFAULT_RESOLUTION,
                 periodic_tiling=False,
                 colormap_name=config.DEFAULT_COLORMAP,
                 canvas_class=None,
                 render_mode="univariate",
                 splat_backend=None,
                 mesh=None):
        if render_mode is None:
            render_mode = "univariate"
        self._validate_render_mode(render_mode)
        self._render_mode = render_mode
        self._mesh = mesh
        self._render_resolution = render_resolution
        self._periodic_tiling = periodic_tiling
        self._splat_backend = splat_backend
        self._colorbar = None
        self._sph = None
        self._colormap: ColormapHolder | None = None
        self.crosshairs_visible = False
        self._prevent_sph_rendering = False
        self._last_status_update = 0.0
        self.last_frame: np.ndarray | None = None

        if canvas_class is None:
            canvas_class = canvas_module.canvas_class_for_environment()
        self.canvas = canvas_class(visualizer=self, title="topsy_tpu")

        self.data_loader: AbstractDataLoader = data_loader_class(
            *data_loader_args, **(data_loader_kwargs or {}))
        self.store = ParticleStore(self.data_loader)
        self.periodicity_scale = self.data_loader.get_periodicity_scale()

        self._initialize_overlays()
        self._initialize_sph_and_colormap_and_bar(colormap_name)

    # -- construction helpers ---------------------------------------------------

    def _initialize_overlays(self):
        self._status = TextOverlay(self, "topsy_tpu", (-0.9, 0.9), 40,
                                   color=(1, 1, 1, 1))
        self._scalebar = ScalebarOverlay(self)
        self._crosshairs = Line(self,
                                [(-1, 0, 0, 0), (1, 0, 0, 0), (200, 200, 0, 0),
                                 (0, 1, 0, 0), (0, -1, 0, 0)],
                                (1, 1, 1, 0.3), 10.0)
        self._cube = SimCube(self, (1, 1, 1, 0.3), 10.0)

    def _renderer_class_for_mode(self, render_mode):
        if self._mesh is not None:
            from .render import distributed
            if render_mode in ("rgb", "rgb-hdr"):
                return distributed.DistributedRGBSPHRenderer
            if render_mode == "surface":
                return distributed.DistributedSurfaceSPHRenderer
            return distributed.DistributedSPHRenderer
        if render_mode in ("rgb", "rgb-hdr"):
            return sph.RGBSPHRenderer
        if render_mode == "surface":
            return surface.SurfaceSPHRenderer
        return sph.SPHRenderer

    def _colormap_parameters_for_mode(self, render_mode):
        params = {"weighted_average": self.quantity_name is not None}
        if render_mode == "rgb":
            params.update({"type": "rgb", "hdr": False, "log": True})
        elif render_mode == "rgb-hdr":
            params.update({"type": "rgb", "hdr": True, "log": True})
        elif render_mode == "bivariate":
            params.update({"type": "bivariate"})
        elif render_mode == "surface":
            params.update({"type": "surface"})
        else:
            params.update({"type": "density"})
        return params

    def _initialize_sph_and_colormap_and_bar(self, colormap_name=None):
        # capability check first: a canvas that cannot present the mode's
        # format must fail the switch here (a real initialization failure,
        # caught by _update_render_mode's revert — reference parity:
        # tests/test_render_mode.py:42-67, HDR on an rgba-u8-only canvas)
        fmt = self.canvas_format
        supported = self.canvas.supported_formats()
        if fmt not in supported:
            raise ValueError(
                f"canvas {type(self.canvas).__name__} cannot present "
                f"{fmt!r} (supports {supported}); render mode "
                f"{self._render_mode!r} unavailable")
        if self._sph is not None:
            old_rotation = self._sph.rotation_matrix
            old_position = self._sph.position_offset
            old_scale = self._sph.scale
        else:
            old_rotation = old_position = old_scale = None

        progression = self.data_loader.get_render_progression()
        if self._periodic_tiling:
            if self._mesh is not None:
                from .render.distributed import DistributedPeriodicSPHRenderer
                self._sph = DistributedPeriodicSPHRenderer(
                    self.store, progression, self._render_resolution,
                    self._mesh, self.periodicity_scale,
                    backend=self._splat_backend)
            else:
                self._sph = periodic.PeriodicSPHRenderer(
                    self.store, progression, self._render_resolution,
                    self.periodicity_scale, backend=self._splat_backend)
        else:
            renderer_class = self._renderer_class_for_mode(self._render_mode)
            logger.info("Using %s for render mode %r", renderer_class.__name__,
                        self._render_mode)
            from .render.distributed import MeshSplatterMixin
            if issubclass(renderer_class, MeshSplatterMixin):
                self._sph = renderer_class(self.store, progression,
                                           self._render_resolution, self._mesh,
                                           backend=self._splat_backend)
            else:
                self._sph = renderer_class(self.store, progression,
                                           self._render_resolution,
                                           backend=self._splat_backend)

        self.reset_view(rotation_matrix=old_rotation, position_offset=old_position,
                        scale=old_scale)
        self.invalidate()

        if colormap_name is None and self._colormap is not None:
            colormap_name = self._colormap.get_parameter("colormap_name")
        if colormap_name is None:
            colormap_name = config.DEFAULT_COLORMAP

        self._colormap = ColormapHolder()
        self._colormap.update_parameters({"colormap_name": colormap_name})
        self._initialize_colormap_and_bar()

    def _initialize_colormap_and_bar(self):
        colormap_params = self._colormap_parameters_for_mode(self._render_mode)
        changed_type = self._colormap.update_parameters(colormap_params)
        params = self._colormap.get_parameters()

        show_colorbar = (params["type"] not in ("rgb", "surface")
                         or (params["type"] == "surface" and params.get("weighted_average")))

        if changed_type or params.get("vmin") is None or params.get("vmax") is None:
            logger.info("Autoranging colormap parameters")
            self._colormap.autorange(self._sph.get_image_device())

        if show_colorbar:
            params = self._colormap.get_parameters()
            self._colorbar = ColorbarOverlay(self, params["vmin"], params["vmax"],
                                             params["colormap_name"],
                                             self._get_colorbar_label())
        else:
            self._colorbar = None

    def _get_colorbar_label(self):
        label = self.data_loader.get_quantity_label(self.quantity_name)
        if self._colormap.get_parameter("log"):
            label = r"$\log_{10}$ " + label
        return label

    # -- mode switching (reference: visualizer.py:203-232) -----------------------

    @staticmethod
    def _validate_render_mode(render_mode):
        if render_mode not in VALID_RENDER_MODES:
            raise ValueError(f"Invalid render_mode '{render_mode}'. "
                             f"Valid modes: {set(VALID_RENDER_MODES)}")

    def _update_render_mode(self, new_render_mode, revert_on_failure=True):
        self._validate_render_mode(new_render_mode)
        old_render_mode = getattr(self, "_render_mode", None)
        self._render_mode = new_render_mode
        try:
            self._initialize_sph_and_colormap_and_bar()
        except Exception:
            if revert_on_failure and old_render_mode is not None:
                logger.error("Failed to switch to render mode %r; reverting to %r",
                             new_render_mode, old_render_mode)
                self._update_render_mode(old_render_mode, revert_on_failure=False)
            raise
        self.invalidate(DrawReason.CHANGE)

    # -- properties (reference: visualizer.py:199-309) ----------------------------

    @property
    def colormap(self) -> ColormapHolder:
        return self._colormap

    @property
    def render_mode(self):
        return self._render_mode

    @render_mode.setter
    def render_mode(self, value):
        self._update_render_mode(value)

    @property
    def canvas_format(self) -> str:
        return "rgba16float" if self._render_mode.endswith("hdr") else "rgba8unorm"

    @property
    def rotation_matrix(self):
        return self._sph.rotation_matrix

    @rotation_matrix.setter
    def rotation_matrix(self, value):
        self._sph.rotation_matrix = value
        self.invalidate()

    @property
    def position_offset(self):
        return self._sph.position_offset

    @position_offset.setter
    def position_offset(self, value):
        self._sph.position_offset = value
        self.invalidate()

    @property
    def scale(self):
        """Viewport half-width in world units (reference: visualizer.py:274-282)."""
        return self._sph.scale

    @scale.setter
    def scale(self, value):
        self._sph.scale = value
        self.invalidate()

    @property
    def quantity_name(self):
        return self.store.quantity_name

    @quantity_name.setter
    def quantity_name(self, value):
        if value == self.store.quantity_name:
            return
        if value is not None:
            try:
                self.data_loader.get_named_quantity(value)
            except Exception as e:
                raise ValueError(f"Unable to get quantity named '{value}'") from e
        self.store.quantity_name = value
        self.invalidate(DrawReason.CHANGE)
        self._colormap.update_parameters({"vmin": None, "vmax": None, "log": None})
        self._initialize_colormap_and_bar()

    @property
    def averaging(self):
        return self.quantity_name is not None

    # -- view manipulation ---------------------------------------------------------

    def rotate(self, x_angle, y_angle):
        from .camera import x_rotation_matrix, y_rotation_matrix
        self.rotation_matrix = (x_rotation_matrix(x_angle)
                                @ y_rotation_matrix(y_angle)
                                @ self.rotation_matrix)

    def reset_view(self, rotation_matrix=None, position_offset=None, scale=None):
        if rotation_matrix is None:
            rotation_matrix = np.eye(3)
        if position_offset is None:
            position_offset = -self.data_loader.get_initial_center()
        if scale is None:
            scale = self.data_loader.get_initial_view_width()
        self._sph.rotation_matrix = rotation_matrix
        self._sph.scale = scale
        self._sph.position_offset = position_offset

    def invalidate(self, reason=DrawReason.CHANGE):
        if self._sph is None:
            return
        self._sph.invalidate(reason)
        self.canvas.request_draw(lambda: self.draw(reason))

    def colormap_autorange(self):
        self._colormap.autorange(self._sph.get_image_device())
        self.invalidate(DrawReason.PRESENTATION_CHANGE)

    # -- drawing --------------------------------------------------------------------

    def render_sph(self, draw_reason=DrawReason.CHANGE):
        self._sph.render(draw_reason)

    def draw(self, reason, target=None):
        """Render (if needed) and compose the presentation frame.

        ``target``: optional (width, height); defaults to the canvas size.
        The composed frame (RGBA, uint8 or float16 for HDR) is stored as
        ``self.last_frame`` and handed to the canvas.
        """
        if self._colormap is None:
            return None  # still initializing
        if target is None:
            width, height = self.canvas.width_physical, self.canvas.height_physical
        else:
            width, height = target

        if not self._prevent_sph_rendering:
            self.render_sph(reason)

        frame = self._compose_presentation(width, height)
        self.last_frame = frame
        if hasattr(self.canvas, "present_frame"):
            self.canvas.present_frame(frame)

        if reason != DrawReason.EXPORT and not self._prevent_sph_rendering:
            if self._sph.needs_refine():
                self.invalidate(DrawReason.REFINE)
        return frame

    def _compose_presentation(self, width, height) -> np.ndarray:
        rgba_dev = self._colormap.to_rgba(self._sph.get_output_image(),
                                          self._sph.last_render_mass_scale)
        pres = fit_to_window(rgba_dev, width, height)
        img = np.array(pres, dtype=np.float32)
        # the readback above is the interactive frame's single natural
        # device barrier: feed its completion time (minus the calibrated
        # pure-transfer cost of a frame this size) back to the renderer's
        # deferred LOD/fps timing — barrier-free frames pay ONE host
        # round-trip, here, instead of a second one inside render()
        t_done = time.perf_counter()
        self._sph.notify_presentation_barrier(
            t_done - self._presentation_readback_cost(pres))
        img[..., 3] = 1.0

        if self.show_colorbar and self._colorbar is not None:
            self._colorbar.composite(img)
        if self.show_scalebar:
            self._scalebar.composite(img)
        if self.crosshairs_visible:
            self._crosshairs.composite(img)
        if self._periodic_tiling:
            self._cube.composite(img)
        if self.show_status:
            self._update_and_display_status(img)

        if self.canvas_format == "rgba16float":
            return img.astype(np.float16)
        return (np.clip(img, 0.0, 1.0) * 255 + 0.5).astype(np.uint8)

    def _presentation_readback_cost(self, pres) -> float:
        """Calibrated pure-transfer cost of reading back a presentation
        frame of this (shape, dtype): measured ONCE per shape by re-reading
        the just-completed frame (the device work is done, so the second
        read is transfer + fixed latency only).  Subtracting it from the
        presentation barrier's wall time leaves device time — the quantity
        the LOD scheduler budgets."""
        key = (tuple(getattr(pres, "shape", ())),
               str(getattr(pres, "dtype", "")))
        cache = getattr(self, "_readback_cost_cache", None)
        if cache is None:
            cache = self._readback_cost_cache = {}
        cost = cache.get(key)
        if cost is None:
            t0 = time.perf_counter()
            np.asarray(pres)
            cost = time.perf_counter() - t0
            cache[key] = cost
        return cost

    def display_status(self, text, timeout=0.5):
        self._override_status_text = text
        self._override_status_text_until = time.time() + timeout

    def _update_and_display_status(self, img):
        now = time.time()
        if (hasattr(self, "_override_status_text_until")
                and now < self._override_status_text_until):
            if (self._status.text != self._override_status_text
                    and now - self._last_status_update
                    > config.STATUS_LINE_UPDATE_INTERVAL_RAPID):
                self._status.text = self._override_status_text
                self._last_status_update = now
                self._status.update()
        elif (now - self._last_status_update > config.STATUS_LINE_UPDATE_INTERVAL
                and self._sph.last_render_fps):
            self._last_status_update = now
            text = f"${self._sph.last_render_fps:.0f}$ fps"
            factor = np.round(self._sph.last_render_mass_scale, 1)
            if factor > 1.1:
                text += f" /{factor:.1f}ds"
            geom = self._sph.render_progression.get_fraction_volume_selected()
            if geom < 0.9:
                text += f" /{1.0 / geom:.1f}gf"
            self._status.text = text
            self._status.update()
        self._status.composite(img)

    # -- image access (reference: visualizer.py:452-525) ---------------------------

    def get_sph_image(self) -> np.ndarray:
        """Logical SPH content (post-processed, no colormap)."""
        return self._colormap.sph_raw_output_to_content(
            np.asarray(self._sph.get_image()))

    def get_sph_presentation_image(self) -> np.ndarray:
        """Colormapped SPH image, no overlays."""
        self.render_sph(DrawReason.EXPORT)
        rgba = np.asarray(self._colormap.to_rgba(self._sph.get_output_image(),
                                                 self._sph.last_render_mass_scale))
        if self.canvas_format == "rgba16float":
            return rgba.astype(np.float16)
        return (np.clip(rgba, 0.0, 1.0) * 255 + 0.5).astype(np.uint8)

    def get_presentation_image(self, resolution=(640, 480)) -> np.ndarray:
        """Full presentation frame with overlays at the given size."""
        return self.draw(DrawReason.EXPORT, target=resolution)

    def get_depth_image(self, depth_renderer_reason=DrawReason.CHANGE) -> np.ndarray:
        return self._sph.get_depth_image(depth_renderer_reason)

    @contextmanager
    def prevent_sph_rendering(self):
        """Temporarily block SPH re-rendering for quick screen updates
        (reference: visualizer.py:359-365)."""
        self._prevent_sph_rendering = True
        try:
            yield
        finally:
            self._prevent_sph_rendering = False

    def save(self, filename="output.pdf"):
        """Save to .npy (raw content), .tif/.tiff (float16 HDR image, as the
        reference's HDR workflow writes — reference:
        tests/test_render_output.py:69-141), .png, or a matplotlib-rendered
        figure with colorbar (reference: visualizer.py:528-570)."""
        self._sph.render(DrawReason.EXPORT)
        if filename.endswith(".npy"):
            np.save(filename, self.get_sph_image())
            return
        if filename.endswith((".tif", ".tiff")):
            image = np.asarray(self.get_sph_presentation_image())[..., :3]
            try:
                import tifffile
                tifffile.imwrite(filename, image.astype(np.float16),
                                 photometric="rgb")
            except ImportError:  # vendored fallback (topsy_tpu/hdr_tiff.py)
                from . import hdr_tiff
                hdr_tiff.imwrite(filename, image.astype(np.float16))
            logger.info("Saved %s", filename)
            return
        from .util import require
        require("matplotlib", f"saving {filename}")
        import matplotlib.pyplot as p
        colormap_params = self._colormap.get_parameters()
        fig = p.figure()
        p.clf()
        try:
            p.set_cmap(colormap_params["colormap_name"])
        except ValueError:
            pass
        image = self.get_sph_presentation_image()
        if image.dtype == np.float16:
            image = np.clip(image.astype(np.float32), 0, 1)
        extent = np.array([-1.0, 1.0, -1.0, 1.0]) * self.scale
        p.imshow(image, extent=extent)
        p.xlabel("$x$/kpc")
        if self._colorbar is not None:
            p.colorbar(p.cm.ScalarMappable(
                norm=p.Normalize(vmin=self._colormap.get_parameter("vmin"),
                                 vmax=self._colormap.get_parameter("vmax")),
                cmap=colormap_params["colormap_name"]), ax=p.gca()
            ).set_label(self._colorbar.label)
        p.savefig(filename)
        p.close(fig)
        logger.info("Saved %s", filename)

    def show(self, force=False):
        self.canvas.show()

    def _ipython_display_(self):
        if hasattr(self.canvas, "ipython_display_with_widgets"):
            self.canvas.ipython_display_with_widgets()
        else:
            from IPython.display import display
            display(repr(self))


class Visualizer(SynchronizationMixin, VisualizerBase):
    pass
