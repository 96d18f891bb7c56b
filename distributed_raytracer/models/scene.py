"""Scene model: environments, objects, lights — and baking to device arrays.

The reference splits an Environment into immutables (mesh library) and
mutables (object R-tree + lights + camera) with gob serialization and
per-frame re-linking (shared/state/environment.go:25-98,162-234). The array
design replaces the object graph with flat SoA arrays: at load time all mesh
instances are *baked* into one world-space triangle soup (translation-only
placement, object.go:17-22), with per-triangle precomputed intersection data
(Baldwin–Weber style plane + barycentric projectors) so the hot kernel needs
no cross products per ray-triangle pair.

JSON schema matches the reference scene format (environment.go:155-234):
  {"objs": [{"model": path, "pos": {xyz}}], "lights": [{"pos", "col"(u8)}],
   "cam": {"pos", "dir", "fov"}}
Model paths resolve relative to the scene file first, then as given
(environment.go:195-199).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from distributed_raytracer.models.camera import Camera
from distributed_raytracer.models.objparse import MeshData, parse_obj

TRI_PAD = 128  # pad triangle count to a power-of-two block multiple


class SceneArrays(NamedTuple):
    """Device-side scene pytree (all float32 / int32).

    Triangle soup, padded to a multiple of TRI_PAD. Padding triangles have
    geo_n == 0, which makes the intersection denominator 0 -> never hit
    (mirrors how degenerate faces can never pass triangle.go:46's
    incidence != 0 test).
    """

    # Raw geometry (world space).
    p0: np.ndarray        # (T, 3) first vertex
    e1: np.ndarray        # (T, 3) p1 -> p2 edge
    e2: np.ndarray        # (T, 3) p1 -> p3 edge
    # Precomputed intersection data (float64-accurate, stored float32).
    geo_n: np.ndarray     # (T, 3) unnormalized geometric normal e1 x e2
    plane_d: np.ndarray   # (T,)  geo_n . p0
    k_u: np.ndarray       # (T, 3) barycentric-u projector: u = x . k_u + c_u
    k_v: np.ndarray       # (T, 3) barycentric-v projector
    c_u: np.ndarray       # (T,)  -p0 . k_u
    c_v: np.ndarray       # (T,)  -p0 . k_v
    # Shading data.
    n0: np.ndarray        # (T, 3) vertex normals (face normal if mesh had none,
    n1: np.ndarray        #        reproducing triangle.go:24-31's flat/smooth split)
    n2: np.ndarray
    mat_id: np.ndarray    # (T,) int32
    # Materials.
    mat_ka: np.ndarray    # (M, 3)
    mat_kd: np.ndarray    # (M, 3)
    mat_ks: np.ndarray    # (M, 3)
    mat_ns: np.ndarray    # (M,)
    # Lights.
    light_pos: np.ndarray  # (L, 3)
    light_col: np.ndarray  # (L, 3)

    @property
    def num_tris(self) -> int:
        return self.p0.shape[0]


@dataclasses.dataclass
class SceneObject:
    """A mesh instance with translation-only placement (object.go:17-22)."""

    obj_id: int
    model: str
    pos: np.ndarray  # (3,) float64


@dataclasses.dataclass
class Scene:
    """Host-side environment (the Environment/EnvMutables analog)."""

    meshes: Dict[str, MeshData]
    objects: List[SceneObject]
    light_pos: np.ndarray   # (L, 3) float64
    light_col: np.ndarray   # (L, 3) float64, channels in [0, 1]
    camera: Camera

    def set_object_pos(self, obj_id: int, pos) -> None:
        """Move an object (the EnvMutables diff analog). Requires re-bake."""
        for o in self.objects:
            if o.obj_id == obj_id:
                o.pos = np.asarray(pos, dtype=np.float64)
                return
        raise KeyError(f"no object with id {obj_id}")

    # ---- world-space triangle soup ------------------------------------

    def bake(self, dtype=np.float32, tri_pad: int = TRI_PAD) -> SceneArrays:
        """Flatten all instances into padded SoA arrays for the device.

        The analog of the reference's scene/mesh R-tree construction
        (environment.go:183, mesh.go:139) — except the acceleration structure
        here is array layout + (later) a block BVH, not a pointer tree.
        """
        p0s, e1s, e2s, n0s, n1s, n2s, mats = [], [], [], [], [], [], []
        mat_key_to_idx: Dict[tuple, int] = {}
        mat_rows: List[tuple] = []

        for obj in self.objects:
            mesh = self.meshes[obj.model]
            v = mesh.vertices + obj.pos[None, :]  # translation-only placement
            tri = v[mesh.faces_v]                 # (F, 3, 3)
            p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
            e1, e2 = p1 - p0, p2 - p0
            if mesh.has_normals:
                n = mesh.normals[mesh.faces_n]    # (F, 3, 3)
                n0, n1, n2 = n[:, 0], n[:, 1], n[:, 2]
            else:
                # Flat shading: bake the face normal into all three vertex
                # slots; barycentric interpolation then returns it exactly
                # (triangle.go:24-26 vs :29-31).
                fn = np.cross(e1, e2)
                with np.errstate(invalid="ignore", divide="ignore"):
                    fn = fn / np.linalg.norm(fn, axis=1, keepdims=True)
                fn = np.nan_to_num(fn)
                n0 = n1 = n2 = fn
            # Deduplicate materials across meshes.
            local_to_global = []
            for m in mesh.materials:
                key = (m.ka, m.kd, m.ks, m.ns)
                idx = mat_key_to_idx.get(key)
                if idx is None:
                    idx = len(mat_rows)
                    mat_rows.append(key)
                    mat_key_to_idx[key] = idx
                local_to_global.append(idx)
            remap = np.asarray(local_to_global, dtype=np.int32)

            p0s.append(p0); e1s.append(e1); e2s.append(e2)
            n0s.append(n0); n1s.append(n1); n2s.append(n2)
            mats.append(remap[mesh.face_mat])

        if p0s:
            p0 = np.concatenate(p0s); e1 = np.concatenate(e1s); e2 = np.concatenate(e2s)
            n0 = np.concatenate(n0s); n1 = np.concatenate(n1s); n2 = np.concatenate(n2s)
            mat_id = np.concatenate(mats)
        else:
            p0 = e1 = e2 = n0 = n1 = n2 = np.zeros((0, 3))
            mat_id = np.zeros((0,), dtype=np.int32)
        if not mat_rows:
            mat_rows.append(((0.0,) * 3, (1.0,) * 3, (0.0,) * 3, 0.0))

        # Pad to a lane multiple with degenerate (never-hit) triangles.
        t = p0.shape[0]
        t_pad = max(tri_pad, -(-max(t, 1) // tri_pad) * tri_pad)
        pad = t_pad - t

        def padded(a, fill=0.0):
            width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, width, constant_values=fill)

        p0, e1, e2 = padded(p0), padded(e1), padded(e2)
        n0, n1, n2 = padded(n0), padded(n1), padded(n2)
        mat_id = padded(mat_id)

        # Precompute intersection data in float64, then cast.
        geo_n = np.cross(e1, e2)
        plane_d = np.einsum("ij,ij->i", geo_n, p0)
        nn = np.einsum("ij,ij->i", geo_n, geo_n)
        with np.errstate(invalid="ignore", divide="ignore"):
            k_u = np.cross(e2, geo_n) / nn[:, None]
            k_v = np.cross(geo_n, e1) / nn[:, None]
        k_u = np.nan_to_num(k_u, posinf=0.0, neginf=0.0)
        k_v = np.nan_to_num(k_v, posinf=0.0, neginf=0.0)
        c_u = -np.einsum("ij,ij->i", p0, k_u)
        c_v = -np.einsum("ij,ij->i", p0, k_v)

        mat_ka = np.asarray([m[0] for m in mat_rows])
        mat_kd = np.asarray([m[1] for m in mat_rows])
        mat_ks = np.asarray([m[2] for m in mat_rows])
        mat_ns = np.asarray([m[3] for m in mat_rows])

        f = lambda a: np.asarray(a, dtype=dtype)
        return SceneArrays(
            p0=f(p0), e1=f(e1), e2=f(e2),
            geo_n=f(geo_n), plane_d=f(plane_d), k_u=f(k_u), k_v=f(k_v),
            c_u=f(c_u), c_v=f(c_v),
            n0=f(n0), n1=f(n1), n2=f(n2),
            mat_id=np.asarray(mat_id, dtype=np.int32),
            mat_ka=f(mat_ka), mat_kd=f(mat_kd), mat_ks=f(mat_ks), mat_ns=f(mat_ns),
            light_pos=f(self.light_pos), light_col=f(self.light_col),
        )


    @property
    def num_tris(self) -> int:
        """Real (unpadded) triangle count across all instances."""
        return sum(len(self.meshes[o.model].faces_v) for o in self.objects)

    def _bake_bvh_native(self, block_size: int, grouped: bool):
        """One-pass C++ bake (native/drt_native.cpp drt_bake_object): the
        whole per-triangle loop — world-space placement, Baldwin-Weber
        precompute, normals, per-slot AABBs with the bound-epsilon floor —
        runs in OpenMP, writing rows directly at their final Morton/
        gap-aligned slots. Behaviorally identical to the NumPy chain
        (bake + reorder_scene + build_block_bvh, asserted by
        tests/test_native.py) but ~20x faster at 5.24M triangles: the
        reference's load+R-tree build is compiled Go (mesh.go:109-213),
        and this is its native twin. Returns None to fall back."""
        from distributed_raytracer.models import bvh as bvh_mod, native

        if not self.objects or not native.available():
            return None
        counts = [len(self.meshes[o.model].faces_v) for o in self.objects]
        starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        n_real = int(starts[-1])
        if n_real == 0:
            return None

        # Material dedup across meshes — bake()'s exact loop, geometry-free.
        mat_key_to_idx: Dict[tuple, int] = {}
        mat_rows: List[tuple] = []
        remaps = []
        for obj in self.objects:
            mesh = self.meshes[obj.model]
            local = []
            for m in mesh.materials:
                key = (m.ka, m.kd, m.ks, m.ns)
                idx = mat_key_to_idx.get(key)
                if idx is None:
                    idx = len(mat_rows)
                    mat_rows.append(key)
                    mat_key_to_idx[key] = idx
                local.append(idx)
            remaps.append(np.asarray(local, np.int32))
        if not mat_rows:
            mat_rows.append(((0.0,) * 3, (1.0,) * 3, (0.0,) * 3, 0.0))

        if grouped:
            # Per-object Morton + gap alignment: no leaf block ever spans
            # two objects (_grouped_order's layout, same codes/order).
            slot_chunks, id_chunks = [], []
            for oi, obj in enumerate(self.objects):
                mesh = self.meshes[obj.model]
                cent = native.centroids(mesh.vertices, mesh.faces_v, obj.pos)
                codes = native.morton_codes(cent)
                order = np.argsort(codes, kind="stable")
                slots = bvh_mod.gap_aligned_slots(codes[order], block_size)
                full = np.where(slots >= 0,
                                starts[oi] + order[np.maximum(slots, 0)], -1)
                slot_chunks.append(full)
                id_chunks.append(np.full(full.shape, oi, np.int32))
            slot_src = np.concatenate(slot_chunks)
            obj_id = np.concatenate(id_chunks)
        else:
            cents = np.empty((n_real, 3), np.float64)
            for oi, obj in enumerate(self.objects):
                mesh = self.meshes[obj.model]
                cents[starts[oi]:starts[oi + 1]] = native.centroids(
                    mesh.vertices, mesh.faces_v, obj.pos)
            order = native.morton_argsort(cents)
            codes = native.morton_codes(cents)[order]
            slots = bvh_mod.gap_aligned_slots(codes, block_size)
            slot_src = np.where(slots >= 0, order[np.maximum(slots, 0)], -1)
            obj_id = None

        out = native.BakeOut(slot_src.shape[0])
        slot_src = np.ascontiguousarray(slot_src, np.int64)
        for oi, obj in enumerate(self.objects):
            mesh = self.meshes[obj.model]
            native.bake_object(out, mesh.vertices, mesh.faces_v,
                               mesh.faces_n, mesh.normals, mesh.has_normals,
                               remaps[oi][mesh.face_mat], obj.pos, slot_src,
                               int(starts[oi]), int(starts[oi + 1]))
        lo, hi = native.block_bounds(out, block_size)
        f = lambda a: np.asarray(a, np.float32)
        arrays = SceneArrays(
            p0=out.p0, e1=out.e1, e2=out.e2, geo_n=out.geo_n,
            plane_d=out.plane_d, k_u=out.k_u, k_v=out.k_v,
            c_u=out.c_u, c_v=out.c_v, n0=out.n0, n1=out.n1, n2=out.n2,
            mat_id=out.mat_id,
            mat_ka=f([m[0] for m in mat_rows]),
            mat_kd=f([m[1] for m in mat_rows]),
            mat_ks=f([m[2] for m in mat_rows]),
            mat_ns=f([m[3] for m in mat_rows]),
            light_pos=f(self.light_pos), light_col=f(self.light_col))
        tree = bvh_mod.BlockBVH(block_lo=lo, block_hi=hi,
                                block_size=block_size)
        if grouped:
            block_obj = obj_id.reshape(-1, block_size)[:, 0]
            obj_pos0 = np.stack([o.pos for o in self.objects])
            return arrays, tree, obj_id, block_obj, obj_pos0.astype(np.float32)
        return arrays, tree

    def bake_bvh(self, block_size: int = 128, dtype=np.float32):
        """bake() + Morton reorder + gap-aligned leaf blocks + block AABBs.

        Returns (SceneArrays in Morton order, BlockBVH). The array analog of
        building the reference's R-trees at load time (mesh.go:139,
        environment.go:183). Block boundaries align to Morton-code gaps
        (bvh.gap_aligned_slots) so a leaf never spans spatially distant
        clusters — padding triangles are degenerate zero rows.

        Dispatches to the one-pass C++ bake (_bake_bvh_native) when the
        native library is available; the NumPy chain below is the
        behavioral reference and fallback.
        """
        from distributed_raytracer.models import bvh as bvh_mod

        if dtype == np.float32:
            got = self._bake_bvh_native(block_size, grouped=False)
            if got is not None:
                return got
        arrays = self.bake(dtype=dtype, tri_pad=block_size)
        n_real = self.num_tris
        p0 = np.asarray(arrays.p0, np.float64)
        e1 = np.asarray(arrays.e1, np.float64)
        e2 = np.asarray(arrays.e2, np.float64)
        order = bvh_mod.morton_order(p0, e1, e2, n_real)[:n_real]
        centroids = p0[:n_real] + (e1[:n_real] + e2[:n_real]) / 3.0
        codes = bvh_mod.morton_codes(centroids)[order]
        slots = bvh_mod.gap_aligned_slots(codes, block_size)
        full = np.where(slots >= 0, order[np.maximum(slots, 0)], -1)
        arrays = bvh_mod.reorder_scene(arrays, full)
        tree = bvh_mod.build_block_bvh(arrays, slots >= 0, block_size)
        return arrays, tree

    def bake_bvh_grouped(self, block_size: int = 128, dtype=np.float32):
        """bake_bvh with per-OBJECT Morton ordering: no leaf block ever
        spans two objects, so a per-frame object translation (SceneDiff)
        shifts each block's AABB exactly — the structural requirement of
        the dynamic renderer (ops/render_dynamic.py).

        Returns (arrays, tree, obj_id (T,) int32 owner per slot,
        block_obj (NB,) int32 owner per block, obj_pos0 (O, 3) float32
        baked object positions)."""
        from distributed_raytracer.models import bvh as bvh_mod

        if dtype == np.float32:
            got = self._bake_bvh_native(block_size, grouped=True)
            if got is not None:
                return got
        arrays = self.bake(dtype=dtype, tri_pad=block_size)
        slots, obj_id = _grouped_order(self, arrays, block_size)
        arrays = bvh_mod.reorder_scene(arrays, slots)
        tree = bvh_mod.build_block_bvh(arrays, slots >= 0, block_size)
        block_obj = obj_id.reshape(-1, block_size)[:, 0]
        obj_pos0 = (np.stack([o.pos for o in self.objects])
                    if self.objects else np.zeros((0, 3)))
        return (arrays, tree, obj_id, block_obj,
                obj_pos0.astype(np.float32))

    def make_diff(self) -> "SceneDiff":
        """Snapshot the current mutable state as a per-frame diff (the
        master gob-encoding EnvMutables each frame, master/main.go:260-262)."""
        obj_pos = (np.stack([o.pos for o in self.objects])
                   if self.objects else np.zeros((0, 3)))
        return SceneDiff(obj_pos=obj_pos.astype(np.float32),
                         light_pos=np.asarray(self.light_pos, np.float32),
                         light_col=np.asarray(self.light_col, np.float32))


class SceneDiff(NamedTuple):
    """Per-frame mutable scene state — the EnvMutables analog
    (shared/state/environment.go:65-69: object positions + lights + camera;
    the camera already rides every render call).

    Where the reference gob-encodes the diff and every worker re-links + rebuilds
    its R-tree per order (worker/distributed/main.go:56-64,
    environment.go:73-98), here the diff is a tiny device pytree folded into
    the baked arrays *on device under jit* (ops/render_dynamic.py) —
    translation only touches plane_d/c_u/c_v/p0 and shifts whole-object
    block AABBs, so no host re-bake or BVH rebuild happens at frame rate.
    """

    obj_pos: np.ndarray    # (O, 3) float32 ABSOLUTE object positions
    light_pos: np.ndarray  # (L, 3) float32
    light_col: np.ndarray  # (L, 3) float32


def _grouped_order(scene: "Scene", arrays: SceneArrays, block_size: int):
    """Per-object Morton ordering + gap alignment (objects never share a
    leaf block, so a per-object translation shifts each block AABB exactly).

    Returns (slots, obj_id) where slots is the reorder_scene map (-1 =
    padding) and obj_id tags every output slot with its owner object index.
    """
    from distributed_raytracer.models import bvh as bvh_mod

    p0 = np.asarray(arrays.p0, np.float64)
    e1 = np.asarray(arrays.e1, np.float64)
    e2 = np.asarray(arrays.e2, np.float64)
    counts = [len(scene.meshes[o.model].faces_v) for o in scene.objects]
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    slot_chunks, id_chunks = [], []
    for oi in range(len(scene.objects)):
        a, b = int(starts[oi]), int(starts[oi + 1])
        cent = p0[a:b] + (e1[a:b] + e2[a:b]) / 3.0
        codes = bvh_mod.morton_codes(cent)
        order = np.argsort(codes, kind="stable")
        slots = bvh_mod.gap_aligned_slots(codes[order], block_size)
        full = np.where(slots >= 0, a + order[np.maximum(slots, 0)], -1)
        slot_chunks.append(full)
        id_chunks.append(np.full(full.shape, oi, np.int32))
    if not slot_chunks:
        return (np.full(block_size, -1, np.int64),
                np.zeros(block_size, np.int32))
    return np.concatenate(slot_chunks), np.concatenate(id_chunks)


def load_scene(path: str) -> Scene:
    """Load a JSON scene (the EnvironmentFromFile analog, environment.go:162-234)."""
    with open(path, "r") as fh:
        data = json.load(fh)

    meshes: Dict[str, MeshData] = {}
    objects: List[SceneObject] = []
    for i, stored in enumerate(data.get("objs", [])):
        model = stored["model"]
        if model not in meshes:
            rel = os.path.join(os.path.dirname(path), model)
            mesh_path = rel if os.path.exists(rel) else model
            meshes[model] = parse_obj(mesh_path)
        pos = stored["pos"]
        objects.append(SceneObject(
            obj_id=i + 1,  # ids are 1..N (environment.go:209)
            model=model,
            pos=np.asarray([pos["x"], pos["y"], pos["z"]], dtype=np.float64),
        ))

    lights = data.get("lights", [])
    light_pos = np.asarray(
        [[l["pos"]["x"], l["pos"]["y"], l["pos"]["z"]] for l in lights], dtype=np.float64
    ).reshape(-1, 3)
    light_col = np.asarray(
        [[l["col"]["r"] / 255.0, l["col"]["g"] / 255.0, l["col"]["b"] / 255.0] for l in lights],
        dtype=np.float64,
    ).reshape(-1, 3)  # colour.go:28-30 NewRGB semantics

    cam = data["cam"]
    camera = Camera.create(
        pos=[cam["pos"]["x"], cam["pos"]["y"], cam["pos"]["z"]],
        direction=[cam["dir"]["x"], cam["dir"]["y"], cam["dir"]["z"]],
        fov=cam["fov"],
    )
    return Scene(meshes=meshes, objects=objects,
                 light_pos=light_pos, light_col=light_col, camera=camera)
