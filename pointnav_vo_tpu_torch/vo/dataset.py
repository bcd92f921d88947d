"""VO frame-pair datasets, host side (counterpart of ``vo/dataset.py``).

- :class:`FramePairReader` streams the reference's chunked HDF5 schema
  (``chunk_{k}`` groups: rgb uint8 and depth float16 flattened, global
  poses, delta position and rotation), with per-action filtering,
  partial-data splits, chunk sharding, and the inverse augmentation: a turn
  sample's frames swapped, its action flipped and its target recomputed
  from the global poses (:func:`inverse_delta_from_global`).  A batch made
  wholly of adjacent (primary, swapped) twins ships each entry's pixels
  once (``FramePairBatch.twins_packed``); the device expands them.
- :class:`MemoryFramePairs` rolls a scripted env (a follower such as
  :func:`oracle_goal_follower`, or any action rule) into frame pairs held
  in memory, with the reader's batch interface: training where ``h5py`` is
  missing.
- :class:`PrefetchingLoader` hides the decode behind device work on a
  thread.
- :func:`generate_dataset` rolls a follower through an env and writes the
  reference schema; :func:`iter_rollout_entries` is its rollout as an
  iterator of entries, which needs no ``h5py``, and
  :func:`generate_dataset_parallel` forks one writer a shard.

``h5py`` is imported inside the reader and the writer only, so the engine
imports without it.  The reader decodes and shuffles; depth discretisation
and the top-down projection run on the device in the train step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from pointnav_vo_tpu_torch.common import (
    CUR_REL_TO_PREV,
    MOVE_FORWARD,
    PREV_REL_TO_CUR,
    STOP,
    TURN_LEFT,
    TURN_RIGHT,
    quat_canonical,
    quat_inverse,
    quat_multiply,
    quat_rotate,
)


def inverse_delta_from_global(prev_rot, prev_pos, cur_rot, cur_pos) -> np.ndarray:
    """``[..., 3]`` = (dx, dz, dyaw) of prev relative to cur: the swapped
    twin's regression target."""
    inv = quat_inverse(cur_rot)
    d_rot = quat_canonical(quat_multiply(inv, prev_rot))
    d_pos = quat_rotate(inv, prev_pos - cur_pos)
    dyaw = 2.0 * np.arctan2(d_rot[..., 1], d_rot[..., 3])
    return np.stack([d_pos[..., 0], d_pos[..., 2], dyaw], -1).astype(np.float32)


@dataclasses.dataclass
class FramePairBatch:
    """One host batch of raw frame pairs (device preprocessing downstream)."""

    prev_rgb: np.ndarray  # [B, H, W, 3] uint8 ([B/2] when twins_packed)
    cur_rgb: np.ndarray
    prev_depth: np.ndarray  # [B, H, W, 1] f16/f32 native ([B/2] when twins_packed)
    cur_depth: np.ndarray
    actions: np.ndarray  # [B] int32 (after the inverse-augmentation flip)
    gt_delta: np.ndarray  # [B, 3] float32 (dx, dz, dyaw)
    data_types: np.ndarray  # [B] int32 CUR_REL_TO_PREV / PREV_REL_TO_CUR
    dz_regress_mask: np.ndarray  # [B] float32
    chunk_idx: np.ndarray  # [B] int32 provenance
    entry_idx: np.ndarray  # [B] int32
    # adjacent (primary, swapped) twins carry each entry's pixels once
    # ([B/2] rows); sample-level fields always have B rows
    twins_packed: bool = False


def _depth_native(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """A flat depth column as ``[N, h, w, 1]``, f16/f32 kept as stored."""
    if arr.dtype not in (np.float16, np.float32):
        arr = arr.astype(np.float32)
    return arr.reshape(-1, h, w, 1)


def unpack_twins(batch: FramePairBatch) -> FramePairBatch:
    """A twin-packed batch with sample-level pixels (sample 2k = entry k,
    sample 2k+1 = entry k with prev/cur swapped)."""
    if not batch.twins_packed:
        return batch

    def interleave(a, b):
        return np.stack([a, b], axis=1).reshape((-1,) + a.shape[1:])

    return dataclasses.replace(
        batch,
        prev_rgb=interleave(batch.prev_rgb, batch.cur_rgb),
        cur_rgb=interleave(batch.cur_rgb, batch.prev_rgb),
        prev_depth=interleave(batch.prev_depth, batch.cur_depth),
        cur_depth=interleave(batch.cur_depth, batch.prev_depth),
        twins_packed=False,
    )


def resolve_dataset_paths(path) -> List[str]:
    """A dataset spec as a file list: one path, a list/tuple, a
    comma-separated string, or a glob pattern (sorted)."""
    if isinstance(path, (list, tuple)):
        return [str(p) for p in path]
    if "," in str(path):
        return [p.strip() for p in str(path).split(",") if p.strip()]
    if any(ch in str(path) for ch in "*?["):
        import glob

        out = sorted(glob.glob(str(path)))
        if not out:
            raise FileNotFoundError(f"dataset glob matched nothing: {path}")
        return out
    return [str(path)]


class FramePairReader:
    """Chunked HDF5 reader with inverse augmentation and chunk sharding.

    ``path`` may be a file, a list of files, a comma-separated list or a
    glob pattern; the files read as one dataset."""

    def __init__(self, path, vis_size_w: int, vis_size_h: int, act_type=-1,
                 geo_invariance_types: Sequence[str] = (), partial_data_n_splits: int = 1,
                 shard_index: int = 0, num_shards: int = 1):
        import h5py

        self.paths = resolve_dataset_paths(path)
        self.w, self.h = vis_size_w, vis_size_h
        if isinstance(act_type, (list, tuple)) and set(act_type) != {TURN_LEFT, TURN_RIGHT}:
            raise ValueError(f"a list act_type must be [2, 3], got {act_type!r}")
        self.act_type = act_type
        self.geo_types = tuple(geo_invariance_types)
        self.n_splits = partial_data_n_splits
        chunks = []
        for pth in self.paths:
            with h5py.File(pth, "r") as f:
                keys = sorted(f.keys(), key=lambda k: int(k.split("_")[-1]))
                chunks.extend((pth, k) for k in keys)
        self.chunks = chunks[shard_index::num_shards]
        self._len = 0
        for pth, k in self.chunks:
            with h5py.File(pth, "r") as f:
                self._len += self._valid_indices(f[k]["actions"][()]).size

    def _valid_indices(self, actions: np.ndarray) -> np.ndarray:
        if isinstance(self.act_type, (list, tuple)):
            mask = (actions == TURN_LEFT) | (actions == TURN_RIGHT)
        elif self.act_type == -1:
            mask = np.ones_like(actions, bool)
        else:
            mask = actions == self.act_type
        idx = np.flatnonzero(mask)
        return idx[:: self.n_splits] if self.n_splits > 1 else idx

    def __len__(self) -> int:
        """Number of primary (non-augmented) samples."""
        return self._len

    def _sample_plan(self, a: int) -> Tuple[bool, bool]:
        """(primary kept, swapped twin added) for an entry of action ``a``."""
        inv_requested = ("inverse_data_augment_only" in self.geo_types
                         or "inverse_joint_train" in self.geo_types)
        joint = "inverse_joint_train" in self.geo_types
        primary = (self.act_type == -1
                   or (isinstance(self.act_type, int) and a == self.act_type)
                   or joint)
        twin = (inv_requested and a != MOVE_FORWARD and self.act_type != -1
                and (joint or a != self.act_type))
        return primary, twin

    def num_samples(self) -> int:
        """Exact number of samples one epoch yields (primaries and twins):
        the expected total of the engine's eval count check."""
        import h5py

        total = 0
        for pth, key in self.chunks:
            with h5py.File(pth, "r") as f:
                actions = f[key]["actions"][()]
            for a in actions[self._valid_indices(actions)]:
                total += sum(self._sample_plan(int(a)))
        return total

    def _decode_chunk(self, grp) -> Dict[str, np.ndarray]:
        h, w = self.h, self.w
        return {
            "actions": grp["actions"][()].astype(np.int32),
            "prev_rgb": grp["prev_rgbs"][()].reshape(-1, h, w, 3),
            "cur_rgb": grp["cur_rgbs"][()].reshape(-1, h, w, 3),
            # depth keeps its stored dtype; the device upcasts (exactly)
            "prev_depth": _depth_native(grp["prev_depths"][()], h, w),
            "cur_depth": _depth_native(grp["cur_depths"][()], h, w),
            "delta_pos": grp["delta_positions"][()].astype(np.float32),
            "delta_rot": grp["delta_rotations"][()].astype(np.float32),
            "prev_gpos": grp["prev_global_positions"][()].astype(np.float64),
            "prev_grot": grp["prev_global_rotations"][()].astype(np.float64),
            "cur_gpos": grp["cur_global_positions"][()].astype(np.float64),
            "cur_grot": grp["cur_global_rotations"][()].astype(np.float64),
        }

    def _chunk_samples(self, data: Dict[str, np.ndarray], idx: np.ndarray) -> List[Tuple]:
        """Valid entries as sample descriptors (entry, swapped?, action, delta)."""
        out = []
        dyaw = 2.0 * np.arctan2(data["delta_rot"][:, 1], data["delta_rot"][:, 3])
        deltas = np.stack([data["delta_pos"][:, 0], data["delta_pos"][:, 2], dyaw],
                          -1).astype(np.float32)
        for i in idx:
            a = int(data["actions"][i])
            primary, twin = self._sample_plan(a)
            if primary:
                out.append((i, False, a, deltas[i]))
            if twin:
                flipped = TURN_RIGHT if a == TURN_LEFT else TURN_LEFT
                inv_delta = inverse_delta_from_global(
                    data["prev_grot"][i], data["prev_gpos"][i],
                    data["cur_grot"][i], data["cur_gpos"][i])
                out.append((i, True, flipped, inv_delta))
        return out

    def iter_batches(self, batch_size: int, rng: Optional[np.random.Generator] = None,
                     drop_last: bool = False) -> Iterator[FramePairBatch]:
        """One epoch.  Chunks load whole; with ``rng`` the chunk order and
        the entries within each chunk are shuffled (entries, not samples: a
        sample and its twin stay adjacent)."""
        import h5py

        chunk_order = list(range(len(self.chunks)))
        if rng is not None:
            rng.shuffle(chunk_order)
        pending: List[Tuple[int, Dict, Tuple]] = []
        files: Dict[str, "h5py.File"] = {}
        try:
            for ci in chunk_order:
                pth, key = self.chunks[ci]
                if pth not in files:
                    files[pth] = h5py.File(pth, "r")
                data = self._decode_chunk(files[pth][key])
                idx = self._valid_indices(data["actions"])
                if rng is not None:
                    idx = rng.permutation(idx)
                for s in self._chunk_samples(data, idx):
                    pending.append((ci, data, s))
                    if len(pending) == batch_size:
                        yield self._assemble(pending)
                        pending = []
            if pending and not drop_last:
                yield self._assemble(pending)
        finally:
            for f in files.values():
                f.close()

    @staticmethod
    def _is_twin_layout(items) -> bool:
        """True when the batch is wholly adjacent (primary, swapped) twins
        of the same entries."""
        if len(items) % 2:
            return False
        for k in range(0, len(items), 2):
            ci0, _, (i0, sw0, _, _) = items[k]
            ci1, _, (i1, sw1, _, _) = items[k + 1]
            if sw0 or not sw1 or ci0 != ci1 or i0 != i1:
                return False
        return True

    @staticmethod
    def _assemble(items) -> FramePairBatch:
        prev_rgb, cur_rgb, prev_d, cur_d = [], [], [], []
        acts, deltas, dtypes, chunk_is, entry_is = [], [], [], [], []
        twins_packed = FramePairReader._is_twin_layout(items)
        for ci, data, (i, swapped, a, delta) in items:
            first, second = ("cur", "prev") if swapped and not twins_packed else ("prev", "cur")
            if not (twins_packed and swapped):  # packed twins: pixels once per entry
                prev_rgb.append(data[f"{first}_rgb"][i])
                cur_rgb.append(data[f"{second}_rgb"][i])
                prev_d.append(data[f"{first}_depth"][i])
                cur_d.append(data[f"{second}_depth"][i])
            dtypes.append(PREV_REL_TO_CUR if swapped else CUR_REL_TO_PREV)
            acts.append(a)
            deltas.append(delta)
            chunk_is.append(ci)
            entry_is.append(i)
        return FramePairBatch(
            prev_rgb=np.stack(prev_rgb), cur_rgb=np.stack(cur_rgb),
            prev_depth=np.stack(prev_d), cur_depth=np.stack(cur_d),
            actions=np.asarray(acts, np.int32),
            gt_delta=np.stack(deltas).astype(np.float32),
            data_types=np.asarray(dtypes, np.int32),
            dz_regress_mask=np.ones(len(acts), np.float32),
            chunk_idx=np.asarray(chunk_is, np.int32),
            entry_idx=np.asarray(entry_is, np.int32),
            twins_packed=twins_packed,
        )


def oracle_goal_follower(turn_angle_deg: float, success_distance: float):
    """``f(env, obs, rng) -> action``: turn toward the goal until roughly
    facing it, else move forward; STOP within the success distance (JAX
    ``vo/dataset.py::oracle_goal_follower``)."""
    turn_rad = np.radians(turn_angle_deg)

    def follower(env, obs, rng=None) -> int:
        bearing = -obs["pointgoal_with_gps_compass"][1]
        if env.dist_to_goal < success_distance:
            return STOP
        if abs(bearing) > turn_rad / 2:
            return TURN_LEFT if bearing < 0 else TURN_RIGHT
        return MOVE_FORWARD

    return follower


class MemoryFramePairs:
    """Frame pairs held in memory, with the reader interface the training
    engine takes (``iter_batches``, ``num_samples``).  An entry is (prev
    rgb uint8, prev depth float16, cur rgb, cur depth, action, global
    poses, target), as the HDF5 schema stores them; the target is the
    delta of cur relative to prev.  With ``twins`` each entry also yields
    its swapped twin right after it (the opposite turn, its target from
    the global poses), and a batch of whole twins ships each entry's frames
    once."""

    def __init__(self, entries: List[Tuple], twins: bool = False):
        self.entries = entries
        self.twins = twins

    @classmethod
    def scripted(cls, n: int, action_fn: Callable, seed: int, twins: bool = False,
                 env_cfg=None) -> "MemoryFramePairs":
        """``n`` steps of a scripted env (``rl.envs.EnvConfig`` ``env_cfg``,
        the default one where None) under ``action_fn(env, obs, rng)``; a
        STOP ends the episode unrecorded, as the JAX package's dataset
        generation does."""
        from pointnav_vo_tpu_torch.rl.envs import EnvConfig, ScriptedPointNavEnv

        env = ScriptedPointNavEnv(env_cfg or EnvConfig(), seed=seed)
        rng = np.random.default_rng(seed)
        obs, entries = env.reset(), []
        while len(entries) < n:
            a = int(action_fn(env, obs, rng))
            if a == STOP:
                obs = env.reset()
                continue
            pos0, rot0 = env.global_pose()
            new, _r, done, _i = env.step(a)
            pos1, rot1 = env.global_pose()
            entries.append((obs["rgb"].astype(np.uint8), obs["depth"].astype(np.float16),
                            new["rgb"].astype(np.uint8), new["depth"].astype(np.float16),
                            a, (pos0, rot0, pos1, rot1),
                            inverse_delta_from_global(rot1, pos1, rot0, pos0)))
            obs = env.reset() if done else new
        return cls(entries, twins)

    @classmethod
    def from_rollout(cls, entries: Iterable[Dict[str, np.ndarray]], h: int, w: int,
                     twins: bool = False) -> "MemoryFramePairs":
        """The entries of :func:`iter_rollout_entries` (the rows of the
        HDF5 file :func:`generate_dataset` writes) as ``h x w`` frame pairs
        that train exactly as :class:`FramePairReader` reads the file: the
        target from the stored delta position and rotation, the twin's
        from the stored global poses."""
        out = []
        for e in entries:
            dp, dr = e["delta_positions"], e["delta_rotations"]
            dyaw = 2.0 * np.arctan2(dr[1], dr[3])
            poses = tuple(e[k].astype(np.float64) for k in (
                "prev_global_positions", "prev_global_rotations", "cur_global_positions",
                "cur_global_rotations"))
            out.append((e["prev_rgbs"].reshape(h, w, 3), _depth_native(e["prev_depths"], h, w)[0],
                        e["cur_rgbs"].reshape(h, w, 3), _depth_native(e["cur_depths"], h, w)[0],
                        int(e["actions"]), poses,
                        np.asarray([dp[0], dp[2], dyaw], np.float32)))
        return cls(out, twins)

    def subset(self, actions: Sequence[int], twins: bool = False) -> "MemoryFramePairs":
        """The entries of the given actions (sharing their frames), as the
        HDF5 reader's ``act_type`` filter picks them."""
        return MemoryFramePairs([e for e in self.entries if e[4] in tuple(actions)], twins)

    def __len__(self) -> int:
        return len(self.entries)

    def num_samples(self) -> int:
        return len(self.entries) * (2 if self.twins else 1)

    def _samples(self, order):
        for e in order:
            _pr, _pd, _cr, _cd, a, (pos0, rot0, pos1, rot1), target = self.entries[e]
            # cur relative to prev; the twin: prev relative to cur
            yield e, False, a, target
            if self.twins:
                flipped = TURN_RIGHT if a == TURN_LEFT else TURN_LEFT
                yield e, True, flipped, inverse_delta_from_global(rot0, pos0, rot1, pos1)

    def iter_batches(self, batch_size: int, rng: Optional[np.random.Generator] = None,
                     drop_last: bool = False) -> Iterator[FramePairBatch]:
        """One epoch, the entries shuffled by ``rng`` (a sample and its twin
        stay adjacent)."""
        order = np.arange(len(self.entries))
        if rng is not None:
            order = rng.permutation(order)
        pending = []
        for sample in self._samples(order):
            pending.append(sample)
            if len(pending) == batch_size:
                yield self._assemble(pending)
                pending = []
        if pending and not drop_last:
            yield self._assemble(pending)

    def _assemble(self, items) -> FramePairBatch:
        packed = (self.twins and len(items) % 2 == 0
                  and all(not items[k][1] and items[k + 1][1]
                          for k in range(0, len(items), 2)))
        pix = {"prev_rgb": [], "prev_depth": [], "cur_rgb": [], "cur_depth": []}
        for e, swapped, _a, _d in items:
            if packed and swapped:
                continue  # packed twins: each entry's frames once
            prev_rgb, prev_d, cur_rgb, cur_d = self.entries[e][:4]
            if swapped:
                prev_rgb, prev_d, cur_rgb, cur_d = cur_rgb, cur_d, prev_rgb, prev_d
            for k, v in zip(pix, (prev_rgb, prev_d, cur_rgb, cur_d)):
                pix[k].append(v)
        n = len(items)
        return FramePairBatch(
            **{k: np.stack(v) for k, v in pix.items()},
            actions=np.asarray([it[2] for it in items], np.int32),
            gt_delta=np.stack([it[3] for it in items]).astype(np.float32),
            data_types=np.asarray([PREV_REL_TO_CUR if it[1] else CUR_REL_TO_PREV
                                   for it in items], np.int32),
            dz_regress_mask=np.ones(n, np.float32),
            chunk_idx=np.zeros(n, np.int32),
            entry_idx=np.asarray([it[0] for it in items], np.int32),
            twins_packed=packed)


class PrefetchingLoader:
    """Background-thread prefetch over any batch iterator (h5py releases the
    interpreter lock while it reads); an error in the feeder is raised in
    the consumer."""

    def __init__(self, make_iter, depth: int = 4):
        self._make_iter = make_iter
        self._depth = depth

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        end = object()
        err = []

        def feed():
            try:
                for item in self._make_iter():
                    q.put(item)
            except Exception as e:  # surfaced in the consumer thread
                err.append(e)
            finally:
                q.put(end)

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is end:
                break
            yield item
        t.join()
        if err:
            raise err[0]


# ---------------------------------------------------------------------------
# dataset generation
# ---------------------------------------------------------------------------

CHUNK_SIZE = 256  # entries an HDF5 group (``chunk_{k}``) holds


def oracle_follower_factory(env):
    """:func:`oracle_goal_follower` with the env's own turn angle and
    success distance: a ``follower_factory``, and so a ``module:callable``
    spec for the generation CLI's ``--follower``."""
    return oracle_goal_follower(env.cfg.turn_angle_deg, env.cfg.success_distance)


def iter_rollout_entries(n_entries: int, env_factory=None, follower_factory=None,
                         env_cfg=None, rnd_p: float = 1.0, seed: int = 0,
                         valid_actions: Optional[Sequence[int]] = None,
                         obs_transform: Optional[Callable] = None
                         ) -> Iterator[Dict[str, np.ndarray]]:
    """The rollout behind :func:`generate_dataset`: ``n_entries`` entries of
    the reference schema (22 arrays each, rgb uint8 and depth float16
    flattened), in the order the file stores them.

    ``env_factory(env_cfg, seed)`` makes the env (the scripted one where
    None); ``follower_factory(env)`` makes ``f(env, obs) -> action``
    (:func:`oracle_goal_follower` where None), whose STOP resets the env
    unrecorded.  A step pair is kept where its action is in
    ``valid_actions`` (all where None) and then, drawn only after that
    test passes, with probability ``rnd_p`` from ``default_rng(seed)``: the
    JAX package's draw order, so a seed gives its entries bit for bit.
    ``obs_transform(image_hwc) -> image_hwc`` (:func:`generate_datasets.
    make_obs_transform`) runs once on each observation a kept pair holds;
    its output is cast with ``astype``, which truncates rgb."""
    from pointnav_vo_tpu_torch.rl.envs import EnvConfig, ScriptedPointNavEnv

    env_cfg = env_cfg or EnvConfig()
    rng = np.random.default_rng(seed)
    env = (env_factory or ScriptedPointNavEnv)(env_cfg, seed=seed)
    follower = (follower_factory(env) if follower_factory is not None
                else oracle_goal_follower(env_cfg.turn_angle_deg, env_cfg.success_distance))
    tf = obs_transform if obs_transform is not None else (lambda x: x)

    def frames(obs):
        return (tf(obs["rgb"]).astype(np.uint8).reshape(-1),
                tf(obs["depth"]).astype(np.float16).reshape(-1))

    written = 0
    obs, obs_frames, new_episode = env.reset(), None, True
    while written < n_entries:
        action = int(follower(env, obs))
        if action == STOP:
            obs, obs_frames, new_episode = env.reset(), None, True
            continue
        prev_gpos, prev_grot = env.global_pose()
        nobs, _r, done, info = env.step(action)
        cur_gpos, cur_grot = env.global_pose()
        keep = ((valid_actions is None or action in valid_actions)
                and rng.uniform() < rnd_p)
        nobs_frames = None
        if keep:
            obs_frames = obs_frames if obs_frames is not None else frames(obs)
            nobs_frames = frames(nobs)
            inv = quat_inverse(prev_grot)  # the delta of cur relative to prev
            d_pos = quat_rotate(inv, cur_gpos - prev_gpos)
            d_rot = quat_canonical(quat_multiply(inv, cur_grot))
            prev_yaw = 2.0 * np.arctan2(prev_grot[1], prev_grot[3])
            cur_yaw = 2.0 * np.arctan2(cur_grot[1], cur_grot[3])
            yield {
                "new_episodes": np.uint8(new_episode),
                "actions": np.uint8(action),
                "collisions": np.uint8(info["collisions"]["count"] > 0),
                "episode_start_positions": np.zeros(3, np.float32),
                "episode_start_rotations": np.zeros(4, np.float32),
                "episode_goal_positions": env.goal_position(),
                "prev_rgbs": obs_frames[0],
                "cur_rgbs": nobs_frames[0],
                "prev_depths": obs_frames[1],
                "cur_depths": nobs_frames[1],
                "prev_point_goal_vecs": obs["pointgoal_with_gps_compass"],
                "cur_point_goal_vecs": nobs["pointgoal_with_gps_compass"],
                "prev_episodic_gpses": np.zeros(2, np.float32),
                "cur_episodic_gpses": np.zeros(2, np.float32),
                "prev_episodic_compasses": np.asarray([prev_yaw], np.float32),
                "cur_episodic_compasses": np.asarray([cur_yaw], np.float32),
                "prev_global_positions": prev_gpos.astype(np.float32),
                "cur_global_positions": cur_gpos.astype(np.float32),
                "prev_global_rotations": prev_grot.astype(np.float32),
                "cur_global_rotations": cur_grot.astype(np.float32),
                "delta_positions": d_pos.astype(np.float32),
                "delta_rotations": np.asarray(d_rot, np.float32),
            }
            written += 1
        new_episode = False
        obs, obs_frames = nobs, nobs_frames
        if done:
            obs, obs_frames, new_episode = env.reset(), None, True


def generate_dataset(path: str, n_entries: int, env_factory=None, follower_factory=None,
                     env_cfg=None, rnd_p: float = 1.0, seed: int = 0,
                     valid_actions: Optional[Sequence[int]] = None,
                     obs_transform: Optional[Callable] = None) -> int:
    """Write :func:`iter_rollout_entries` to ``path`` in the reference's
    chunked HDF5 schema (``chunk_{k}`` groups of :data:`CHUNK_SIZE`
    entries, LZF on the ``*rgbs`` and ``*depths`` datasets); returns the
    number of entries written."""
    import h5py

    written = chunks = 0
    with h5py.File(path, "w") as f:
        buf: List[Dict[str, np.ndarray]] = []

        def flush():
            nonlocal chunks
            grp = f.create_group(f"chunk_{chunks}")
            for k in buf[0]:
                grp.create_dataset(k, data=np.stack([b[k] for b in buf]),
                                   compression="lzf" if k.endswith(("rgbs", "depths")) else None)
            chunks += 1
            buf.clear()

        for entry in iter_rollout_entries(n_entries, env_factory, follower_factory, env_cfg,
                                          rnd_p, seed, valid_actions, obs_transform):
            buf.append(entry)
            written += 1
            if len(buf) == CHUNK_SIZE:
                flush()
        if buf:
            flush()
    return written


def generate_scripted_dataset(path: str, n_entries: int, env_cfg=None, rnd_p: float = 1.0,
                              seed: int = 0) -> int:
    """:func:`generate_dataset` over the scripted env and the oracle follower."""
    return generate_dataset(path, n_entries, env_cfg=env_cfg, rnd_p=rnd_p, seed=seed)


def fork_workers(run: Callable[[int], None], n_workers: int) -> None:
    """``run(i)`` for each ``i < n_workers`` in a forked process of its own,
    one intra-op thread each, as a DataLoader's workers; raises where a
    worker fails.

    The workers are forked, so ``run`` may be a closure.  A process that
    has initialised CUDA cannot fork workers that use the card, so this
    raises where it has, and each worker initialises the card itself."""
    import multiprocessing as mp

    import torch

    if torch.cuda.is_initialized():
        raise RuntimeError("the dataset writers are forked, and this process has "
                           "initialised CUDA: a forked child cannot use the card. Run "
                           "the generation before any CUDA work, or with one worker")

    def child(i):
        torch.set_num_threads(1)
        run(i)

    ctx = mp.get_context("fork")
    procs = [ctx.Process(target=child, args=(i,)) for i in range(n_workers)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    bad = [i for i, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"dataset workers failed: {bad} (exit codes "
                           f"{[procs[i].exitcode for i in bad]})")


def generate_dataset_parallel(path_prefix: str, n_entries: int, n_workers: int,
                              env_factory=None, follower_factory=None, env_cfg=None,
                              rnd_p: float = 1.0, seed: int = 0,
                              valid_actions: Optional[Sequence[int]] = None,
                              obs_transform: Optional[Callable] = None,
                              factory_kwargs: Optional[List[Dict[str, Any]]] = None
                              ) -> List[str]:
    """:func:`generate_dataset` over ``n_workers`` forked processes
    (:func:`fork_workers`), worker ``i`` seeded ``seed + 1000 i`` writing
    ``{path_prefix}.w{i}.h5`` with ``n_entries // n_workers`` entries (the
    last one the remainder too); the files read as one dataset.
    ``factory_kwargs`` is one dict of extra ``env_factory`` keywords a
    worker (its scenes, the task config)."""
    per = [n_entries // n_workers] * n_workers
    per[-1] += n_entries - sum(per)
    paths = [f"{path_prefix}.w{i}.h5" for i in range(n_workers)]

    def run(i):
        ef = env_factory
        if ef is not None and factory_kwargs is not None:
            kw = factory_kwargs[i]
            ef = lambda cfg, seed: env_factory(cfg, seed=seed, **kw)  # noqa: E731
        generate_dataset(paths[i], per[i], env_factory=ef, follower_factory=follower_factory,
                         env_cfg=env_cfg, rnd_p=rnd_p, seed=seed + 1000 * i,
                         valid_actions=valid_actions, obs_transform=obs_transform)

    fork_workers(run, n_workers)
    return paths
