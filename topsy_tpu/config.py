"""Tunables for the renderer.

Behavioural constants mirror the reference semantics (reference:
src/topsy/config.py:1-44); the splat-engine constants (pyramid depth,
chunk sizes, window shapes) are this implementation's own.
"""

# ---------------------------------------------------------------- display ---
DEFAULT_RESOLUTION = 1024
DEFAULT_COLORMAP = "twilight_shifted"

DEFAULT_SCALE = 200.0  # viewport half-width in kpc

TARGET_FPS = 30  # adaptive LOD keeps this
INITIAL_PARTICLES_TO_RENDER = 1e5
STATUS_LINE_UPDATE_INTERVAL = 0.2  # seconds
STATUS_LINE_UPDATE_INTERVAL_RAPID = 0.05

GLIDE_TIME = 0.3  # seconds after double click to reach destination

COLORBAR_ASPECT_RATIO = 0.15
COLORMAP_NUM_SAMPLES = 1000

TEST_DATA_NUM_PARTICLES_DEFAULT = int(1e6)

# ------------------------------------------------------------ particle LOD --
MAX_PARTICLES_PER_BUFFER = 2**27
# kept for API parity with the reference buffer splitting.

MAX_PARTICLES_PER_EXPORT_RENDERCALL = 2**25
# EXPORT renders are chunked into calls of at most this many particles.

DEFAULT_CELLS_NSIDE = 16
# spatial grid used for geometric culling (reference: config.py:27-31)

CELL_LAYOUT_FRACTIONAL_PADDING = 1e-5

# fraction of the frame budget below which no new block is attempted
FRAME_BUDGET_CUTOFF_FRACTION = 0.4

JUPYTER_UI_LAG = 0.05

PROJECTED_DENSITY_NAME = "Projected density"

MAX_SURFACE_SMOOTH_PIXELS = 100

# ----------------------------------------------------------- splat renderer --
SPLAT_KERNEL_RANK = 2
# rank of the separable (eigen) decomposition of the projected SPH kernel;
# rank 2 reproduces the kernel to 1.3e-3 of peak (rank 3: 1.0e-3 — no
# meaningful gain), and the profile-evaluation cost of the deposit scales
# linearly with rank.

SPLAT_POLY_DEGREE = 6
# degree (in t^2) of the polynomial fit to each kernel eigen-profile.  The
# fit is constrained to be exactly zero at the support edge (t^2 = 4) so the
# device evaluator needs no support mask — it just clamps t^2 to 4.  The
# constrained degree-6 fit reproduces the kernel to ~1e-3 of peak (slightly
# better than the unconstrained degree-8 fit it replaced).

SPLAT_MAX_HALF_SIZE_PX = 3.5
# pyramid level is chosen so that the smoothing length in level pixels is at
# most this; footprint (radius 2h <= 7px) then fits in a 16px window.

SPLAT_MIN_HALF_SIZE_PX = 0.71
# smoothing lengths are clamped up to this many (level) pixels so that very
# small splats still cover at least one pixel centre on average; mass is
# conserved exactly via the discrete normalization table.

SPLAT_WINDOW = 16
# side of the square footprint window used by the scatter path, and the
# truncation width of giant splats at the coarsest pyramid level.

SPLAT_PYRAMID_LEVELS = 7
# levels 0..6 -> level L resolution = resolution / 2^L (coarsest 16px).

PYRAMID_COLLAPSE_FILTER = "spline"
# reconstruction filter for the density pyramid collapse
# (ops/composite._upsample2x_matrix): 'spline' (interpolating cubic spline,
# B-spline prefilter folded into the matmul — fourth-order), 'catmull'
# (Catmull-Rom, third-order), 'linear'.  Same run-time cost for all three
# (one precomputed (n, 2n) matmul per axis); 'spline' halves the measured
# coarse-level reconstruction bias vs the exact evaluator
# (benchmarks/pyramid_bias.py).

SPLAT_BAND_ROWS = 8
# rows per sort band; group output windows are aligned to this (the group
# sizes and window shapes themselves live in ops/splat_atlas.py).

SPLAT_ATLAS_PAD = 64
# padding rows between pyramid levels in the atlas canvas (>= WINDOW_ROWS so
# dynamic windows never contaminate a neighbouring level).

SPLAT_ATLAS_COL_PAD = 16
# padding cols on either side of the atlas (edge-clipping margin).

SPLAT_SPILL_GROUP_CAP = 128
# capacity (in main-pass groups) of the dense-fallback pass for particles
# that do not fit their group's accumulation window (sparsely populated
# regions).  Spills are compacted group-granularly (top-k over per-group
# spill counts + row gather) so the fallback never pays a full-length sort.

EXPORT_USE_PRESORTED = True
# EXPORT renders use the static (smoothing-bucket, Morton) particle order
# (ops/morton.py), skipping the per-frame sort entirely.

INTERACTIVE_USE_PRESORTED = True
# Interactive (CHANGE/REFINE) frames also skip the per-frame sort: particles
# are shuffled within each presorted group, so LOD subsets are rendered as
# whole-column slices of the (groups x 512) matrix — spatially fair random
# subsamples with exact photometric scale factors (render/sph.py,
# progression.RenderProgressionColumns).  Builds the presort order at the
# first interactive frame (~1 us/particle, one-time per snapshot).

COLUMN_MIP_FLOOR_TARGET = 1 << 20
# decimation-mip tiers (ops/morton_device.build_mip_layout) are chained
# until the deepest tier holds at most ~8x this many particles (chaining
# stops when the next floor would be under the target).  Interactive
# CHANGE frames render whole tiers (progression.py), so the deepest tier
# bounds the mandatory per-frame block, and the budget-driven promotion
# climbs to larger tiers whenever the measured frame time affords them.

COLUMN_MIP_MAX_TIERS = 2
# upper bound on chained decimation tiers (each costs one extra presort
# build over an 8x smaller subsample plus its array copies).

AUTORANGE_PERCENTILES = (1.0, 99.9)

GPU_TIMING_SMOOTH_WINDOW = 10  # frames of running-mean for fps display
