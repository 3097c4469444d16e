"""Typed configuration for the object-SLAM engine (PyTorch port).

A verbatim copy of the dataclasses of `eao_fusion_tpu/config.py`, kept
field for field so that one config drives both packages; tests assert that
every field and default agree. `SolverConfig.use_pallas_pose` and
`use_pallas_ba_edges` are kept for that parity only: the port ignores them
(a CUDA tensor always goes through the hand-written kernel, a CPU tensor
through its plain PyTorch version).

One typed config replaces the reference's three mechanisms (OpenCV YAML
FileStorage, ROS params, and the hard-coded ``flag`` ablation string —
see SURVEY.md §5.6; reference files `ros_test/config/D435i.yaml`,
`ros_test/src/message_flow.cc:30-41`). All numeric constants that the
reference inlines in code (association thresholds, plane information
weights `src/Optimizer.cc:464-469`, map-plane gates `src/Map.cc:22-23`)
are hoisted here.

Everything is a frozen dataclass so configs hash and can be passed as
static arguments to jitted functions.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole RGBD camera intrinsics (reference: `ros_test/config/TUM3.yaml`)."""

    width: int = 640
    height: int = 480
    fx: float = 535.4
    fy: float = 539.2
    cx: float = 320.1
    cy: float = 247.6
    # Radial/tangential distortion; TUM fr3 images ship pre-rectified.
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    fps: float = 30.0
    # Stereo baseline times fx. RGBD depth is converted to a virtual right
    # coordinate uR = u - bf/z (semantics of `src/Frame.cc:1016`).
    bf: float = 40.0
    # Close/far point threshold in units of baseline (`ThDepth`).
    th_depth: float = 40.0
    # Depth image scale: raw/depth_map_factor = meters.
    depth_map_factor: float = 5000.0

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    @property
    def depth_threshold(self) -> float:
        return self.baseline * self.th_depth


@dataclass(frozen=True)
class ORBConfig:
    """ORB extractor budget (reference: `ros_test/config/D435i.yaml:38-52`)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # Static per-frame keypoint capacity (n_features padded to a TPU-friendly
    # size; unused slots carry valid=False masks).
    max_keypoints: int = 1024
    # Spatial-distribution cell size in pixels at level 0 (the reference uses
    # 30px FAST cells + a quadtree; we use per-cell top-k which is shape-static).
    cell_size: int = 30
    # Gaussian blur before descriptor sampling (sigma 2, 7x7 — ORB standard).
    blur_sigma: float = 2.0


@dataclass(frozen=True)
class MatcherConfig:
    """Matching thresholds — kept numerically faithful to ORB-SLAM2 semantics
    (`src/ORBmatcher.cc:41-43` TH_HIGH/TH_LOW/HISTO_LENGTH and the per-call
    search radii), since they materially affect ATE (SURVEY.md §7.3)."""

    th_high: int = 100
    th_low: int = 50
    nn_ratio: float = 0.9
    histo_length: int = 30
    # Projection search radius in pixels at level 0, scaled by octave.
    radius_motion_model: float = 15.0  # stereo/RGBD uses th=15 px window
    radius_local_map: float = 5.0      # multiplied by viewing-cos factor
    radius_reloc: float = 10.0
    check_orientation: bool = True


@dataclass(frozen=True)
class TrackingConfig:
    """Front-end policy thresholds (reference `src/Tracking.cc`)."""

    # Keyframe decision (NeedNewKeyFrame, `src/Tracking.cc:2300-2466`).
    # The reference's c1b gates insertion on `mnFrameId > mnLastKeyFrameId
    # + mMinFrames && LocalMapping idle` — its mapping thread takes ~2-3
    # camera frames per keyframe, so that idle check is real backpressure
    # (`src/Tracking.cc:2338-2350`, `src/LocalMapping.cc:41-116`). With the
    # mapping branch fused into the per-frame step there is no queue to be
    # busy, so the equivalent floor is explicit: a c2-triggered keyframe
    # needs at least this many frames since the last insertion (c1a's
    # max_frames_between_kf timeout bypasses it).
    min_frames_between_kf: int = 3
    max_frames_between_kf: int = 30  # = fps
    min_matches_track: int = 20      # motion-model tracking accept gate
    min_matches_local_map: int = 30  # local-map tracking accept gate
    kf_ref_ratio: float = 0.75       # tracked-vs-refKF ratio for KF decision
    kf_min_close_points: int = 100   # stereo/RGBD close-point trigger
    kf_max_close_tracked: int = 70
    # Local map caps (`src/Tracking.cc:2731`).
    max_local_keyframes: int = 80
    # Auto-reset if LOST with <= this many keyframes (`src/Tracking.cc:1174`).
    reset_if_lost_below_kfs: int = 5


@dataclass(frozen=True)
class SolverConfig:
    """Optimization schedules (reference `src/Optimizer.cc`)."""

    # Per-frame pose optimization: 4 rounds x 10 iterations with chi2 inlier
    # reclassification between rounds (`src/Optimizer.cc:539-544`).
    pose_rounds: int = 4
    pose_iters_per_round: int = 10
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    # Plane edge weights (`src/Optimizer.cc:464-469`).
    plane_angle_info: float = 3282.8
    plane_dist_info: float = 1.0e4
    plane_chi2: float = 300.0
    # Local BA: 5 + 10 iterations (`src/Optimizer.cc:965-975`). The caps
    # match the reference; like g2o, iterations also end on relative-gain
    # convergence — local BA re-solves an almost-converged window every
    # keyframe, so a 1e-3 gain floor typically saves 2-4 of the ~3 ms LM
    # iterations with no measurable ATE change (global BA keeps 1e-4).
    local_ba_iters_first: int = 5
    local_ba_iters_second: int = 10
    local_ba_ftol: float = 1e-3
    # Global BA iterations (`src/LoopClosing.cc:690`).
    global_ba_iters: int = 20
    # A camera with fewer point observations than this is FIXED in BA: a
    # 6-DoF pose constrained by 2-3 reprojections (or by plane factors
    # alone, which never constrain in-plane sliding) is free to move
    # meters while lowering chi2. Its pose stays where odometry/the
    # essential graph put it — distributing corrections to weakly-observed
    # keyframes is the pose graph's job, not BA's. (The reference never
    # hits this: its mature map points are only erased when culled young,
    # so keyframes keep their observation lists; our dense-table erosion
    # under fast rotation can starve mid-trajectory keyframes.)
    min_cam_obs: int = 15
    # Levenberg-Marquardt damping bracket.
    lm_lambda_init: float = 1.0e-4
    lm_lambda_min: float = 1.0e-10
    lm_lambda_max: float = 1.0e2
    huber_mono: float = 2.447   # sqrt(5.991)
    huber_stereo: float = 2.796  # sqrt(7.815)
    # Run the per-frame pose optimizer as one fused Pallas kernel on TPU
    # (solvers/pose_opt_pallas.py); the XLA path is used on CPU and as the
    # reference implementation for the parity test.
    use_pallas_pose: bool = True
    # Fuse the local-BA per-edge residual/Jacobian/Gram chain into one
    # Pallas kernel on TPU (solvers/ba_edge_pallas.py) — the chain is
    # ~20 tiny XLA kernels otherwise and per-kernel issue latency
    # dominates the LM iteration. XLA path on CPU / as parity reference.
    use_pallas_ba_edges: bool = True


@dataclass(frozen=True)
class PlaneConfig:
    """PEAC-style plane segmentation + plane landmark association.

    Reference: `include/PEAC/AHCPlaneFitter.hpp:152-155` (minSupport 3000 px,
    10x10 windows), `src/Map.cc:22-23` (association gates)."""

    window: int = 10          # pixels per segmentation cell side
    min_support_px: int = 3000
    mse_max: float = 0.0012   # max per-window plane MSE (m^2), depth-adaptive
    merge_normal_dot: float = 0.985  # window merge gate on normal agreement
    merge_dist: float = 0.04  # max plane-to-plane point distance for merge (m)
    # label-propagation sweeps replacing the AHC heap. 12 measured as the
    # convergence point: 8 under-merges on a 48x64 window grid (split
    # plane components bias the fitted d, which the 1e4-weighted distance
    # factor turns into centimeters of pose error).
    n_merge_sweeps: int = 12
    max_planes_per_frame: int = 8
    boundary_voxel: float = 0.05  # 5cm voxel downsample of plane points
    max_boundary_points: int = 256  # per plane, fixed capacity
    # Map association gates (`src/Map.cc:22-23`: fDisTh=0.2, fAngleTh=0.8).
    assoc_angle_cos: float = 0.8
    assoc_dist: float = 0.2
    # Frame-level dedup: planes seen twice in one frame are merged
    # (`src/Frame.cc:349-371` PlaneNotSeen semantics).
    dedup_angle_cos: float = 0.965
    dedup_dist: float = 0.07


# The reference's online-lane class filter (`src/Tracking.cc:437-441`):
# person, handbag, suitcase, bottle, chair, couch, potted plant, bed,
# dining table, tv, laptop, keyboard, phone, book (COCO ids).
COCO_CLASS_WHITELIST: Tuple[int, ...] = (0, 24, 28, 39, 56, 57, 58, 59,
                                         60, 62, 63, 66, 67, 73)


@dataclass(frozen=True)
class ObjectConfig:
    """EAO object subsystem thresholds (reference `src/Object.cc`)."""

    max_objects_2d: int = 16        # per frame
    max_map_objects: int = 64
    max_points_per_object: int = 512
    min_points_init: int = 10       # min associated points to create an object
    # Detector box filtering (`src/Tracking.cc:431-470`): min score, border.
    min_box_score: float = 0.5
    image_border: int = 10
    # Online-lane class whitelist (`src/Tracking.cc:431-452` keeps only
    # {person, ..., book} COCO ids); None = auto — the reference's 14-id
    # COCO list (COCO_CLASS_WHITELIST) is applied when the loaded detector
    # has 80 classes, and no filter otherwise (the in-repo synthetic
    # detector's small class ids are unrelated to COCO). Applied at the
    # detector join, not to offline box files (those are pre-filtered,
    # matching the reference's yolo_txts parity mode).
    class_whitelist: Optional[Tuple[int, ...]] = None
    # Ensemble association (SURVEY §2.1 Object subsystem).
    iou_threshold: float = 0.5
    projected_iou_threshold: float = 0.25
    # Nonparametric rank-sum significance level index into the t-table.
    ranksum_alpha: float = 0.05
    ttest_alpha: float = 0.05
    # Isolation forest (`src/Object.cc:1248-1296`: 50 trees, thr 0.6/0.65).
    iforest_trees: int = 50
    iforest_sample: int = 64
    iforest_threshold: float = 0.6
    iforest_threshold_merged: float = 0.65
    # The reference culls per associated object per FRAME
    # (`DataAssociateUpdate` step 6). Default here is keyframe rate:
    # members only accumulate between keyframes, so the converged cull set
    # is the same, and the per-frame variant costs ~37 ms on TPU (small
    # batched PRNG + tree ops dominate). Set False... set this False to
    # match the reference schedule exactly.
    iforest_keyframe_rate: bool = True
    # Rows per cull pass: the forest runs on the `compact` most recently
    # observed gated objects (membership only changes on observation, so
    # older rows were culled when last touched — same converged cull set as
    # the full-table sweep). 0 = full table. 16 keeps the keyframe-rate
    # cull at ~1/4 of the full-table cost on TPU.
    iforest_compact_rows: int = 16
    # Association ablation flag, mirroring the reference's mode string
    # ("Full"/"NA"/"IoU"/"NP"/"EAO"/"iForest"/"None", DOC/EAO-SLAM-README.md).
    mode: str = "Full"


@dataclass(frozen=True)
class LoopConfig:
    """Loop detection / correction (reference `src/LoopClosing.cc`,
    `src/KeyFrameDatabase.cc`)."""

    covisibility_consistency_th: int = 3
    min_common_words_ratio: float = 0.8   # `KeyFrameDatabase.cc:119`
    acc_score_retain: float = 0.75        # `KeyFrameDatabase.cc:175`
    sim3_ransac_iters: int = 64           # batched hypotheses (vmap)
    sim3_min_inliers: int = 20
    min_sim3_matches: int = 20
    min_accept_matches: int = 40
    fix_scale_rgbd: bool = True
    pose_graph_iters: int = 20
    # Global BA OFF the critical path (the reference's transient GBA
    # thread with the mbStopGBA abort interlock,
    # `src/LoopClosing.cc:594,686-796`): correct() returns after the
    # essential graph and GBA runs on a snapshot in a host thread, in
    # stages of `gba_stage_iters` LM iterations (one device program per
    # stage, so frame steps interleave between stages and an abort takes
    # effect at the next stage boundary). Keyframes/points created while
    # GBA is in flight are merged through the spanning tree afterwards.
    async_gba: bool = True
    gba_stage_iters: int = 5


@dataclass(frozen=True)
class MapCapacity:
    """Fixed capacities of the functional map state. Everything in the map is
    a dense array with a validity mask; these set the array extents."""

    max_keyframes: int = 256
    max_points: int = 16384
    max_planes: int = 32
    max_objects: int = 64
    # Per-keyframe keypoint slots == ORBConfig.max_keypoints.
    # Local BA capacities: the window problem is compacted to these shapes
    # (edge list [max_local_ba_obs], point table [max_local_ba_points]);
    # overflow observations/points are excluded from that BA call (they
    # stay in the map, just not optimized THIS keyframe). Sized ~2-3x the
    # measured window occupancy of a 32-KF local window (~3k edges) —
    # every LM iteration's big tensors ([Pw, E] one-hot, [C, Pw] A-grid)
    # scale with these, so padding here is pure per-keyframe cost.
    max_local_ba_obs: int = 8192
    max_local_ba_kfs: int = 32
    max_local_ba_points: int = 2048
    # Covisible neighbors visited by SearchInNeighbors-style fusion
    # (reference nn=10 for RGBD, `src/LocalMapping.cc:462`; both fuse
    # directions run per neighbor, batched via vmap).
    fuse_neighbors: int = 10
    # Covisible neighbors for monocular triangulation
    # (`src/LocalMapping.cc:216`: nn=20 mono; our keyframes are ~2x
    # sparser than the reference's on the synthetic sequences, so 8
    # covisible neighbors span a comparable baseline set).
    triangulation_neighbors: int = 8


@dataclass(frozen=True)
class BoWConfig:
    """Flat visual vocabulary (TPU re-design of DBoW2's k-ary tree: direct
    nearest-word assignment by one ±1-bit matmul; see
    eao_fusion_tpu/mapping/vocabulary.py)."""

    n_words: int = 8192
    # tf-idf weighting and L1 scoring, per DBoW2 defaults.
    use_tfidf: bool = True


@dataclass(frozen=True)
class ImuConfig:
    """World-frame gravity alignment at init (reference
    `ros_test/src/message_flow.cc:270-308`)."""

    # ConstraintType: 0 = none, 1 = ground-truth pose, 2 = IMU gravity
    # (`ros_test/config/D435i.yaml:31-34`).
    constraint_type: int = 0
    gravity_axis: int = 3


@dataclass(frozen=True)
class SystemConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: ORBConfig = field(default_factory=ORBConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    planes: PlaneConfig = field(default_factory=PlaneConfig)
    objects: ObjectConfig = field(default_factory=ObjectConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    capacity: MapCapacity = field(default_factory=MapCapacity)
    bow: BoWConfig = field(default_factory=BoWConfig)
    imu: ImuConfig = field(default_factory=ImuConfig)
    # Sensor mode: "rgbd" | "mono"  (stereo reserved).
    sensor: str = "rgbd"
    # Run detector online (JAX YOLOX) vs. offline box files
    # (reference `~online` ROS param, `src/Tracking.cc:476-524`).
    semantic_online: bool = False
    use_planes: bool = True
    use_objects: bool = True
    use_loop_closing: bool = True
    # Distributed global BA: when >1 and that many devices are attached,
    # LoopCloser._global_ba shards the point table / observations over an
    # ``lm`` mesh of this size (parallel/dist_ba.py). 0/1 = single-device.
    gba_mesh_devices: int = 0

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def tum_fr3_config(**overrides) -> SystemConfig:
    """Config matching TUM fr3 sequences (reference `ros_test/config/TUM3.yaml`)."""
    cam = CameraConfig(fx=535.4, fy=539.2, cx=320.1, cy=247.6,
                       bf=40.0, th_depth=40.0, depth_map_factor=5000.0)
    return SystemConfig(camera=cam).replace(**overrides)


def d435i_config(**overrides) -> SystemConfig:
    """Config matching the RealSense D435i (reference `ros_test/config/D435i.yaml`)."""
    cam = CameraConfig(fx=615.45, fy=615.55, cx=324.69, cy=238.91,
                       bf=40.0, th_depth=40.0, depth_map_factor=1000.0)
    return SystemConfig(camera=cam, imu=ImuConfig(constraint_type=2)).replace(**overrides)
