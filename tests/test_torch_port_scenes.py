"""The port's analytic scenes (``neuray_tpu_torch/data/synthetic.py``)
against the JAX package's (``neuray_tpu/data/synthetic.py``) and the pan
tool's geometry against ``tools/check_trajectory_escalation.py``: every
array byte for byte, over several seeds and sizes, and the defaults'
arrays (the unit sphere every earlier path renders) unchanged."""
import os
import sys

import numpy as np
import pytest
import torch

from neuray_tpu.data import synthetic as J

from neuray_tpu_torch.data import synthetic as P

torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def same(a, b):
    """Equal byte for byte, dtype and shape included."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def same_dicts(a, b):
    assert a.keys() == b.keys()
    for k in a:
        same(a[k], b[k])


def test_constants():
    assert P.ROOM_RADIUS == J.ROOM_RADIUS
    assert P.ROOM_DEPTH_RANGE == J.ROOM_DEPTH_RANGE
    assert P.DEPTH_RANGE == J.DEPTH_RANGE and P.RADIUS == J.RADIUS
    assert P.UNIT_SPHERE == J.UNIT_SPHERE


@pytest.mark.parametrize("seed", [0, 1, 42, 1234])
def test_sphere_lists(seed):
    for n in (3, 5):
        assert (P.make_blob_spheres(np.random.RandomState(seed), n)
                == J.make_blob_spheres(np.random.RandomState(seed), n))
    assert (P.make_room_spheres(np.random.RandomState(seed))
            == J.make_room_spheres(np.random.RandomState(seed)))
    assert P.make_pan_scene_spheres() == J.make_pan_scene_spheres()


@pytest.mark.parametrize("scene", ["room", "blobs", "pan"])
@pytest.mark.parametrize("seed,h,w", [(0, 64, 64), (3, 48, 80),
                                      (42, 33, 17)])
def test_render_spheres_view(scene, seed, h, w):
    """The textured room at 64 px, the blobs and the pan scene, each from
    cameras on the shell: rgb, z-depth and hit mask."""
    spheres = {"room": J.make_room_spheres, "blobs": J.make_blob_spheres,
               "pan": lambda rng: J.make_pan_scene_spheres()}[scene](
        np.random.RandomState(seed))
    rng_j, rng_p = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):
        pose, K = J.look_at_camera(rng_j, h, w)
        for a, b in zip((pose, K), P.look_at_camera(rng_p, h, w)):
            same(a, b)
        for a, b in zip(J.render_spheres_view(pose, K, h, w, spheres),
                        P.render_spheres_view(pose, K, h, w, spheres)):
            same(a, b)
    if scene == "room":
        _, _, hit = P.render_spheres_view(pose, K, h, w, spheres)
        assert hit.all()                 # every ray meets the room


def test_render_sphere_view():
    pose, K = J.look_at_camera(np.random.RandomState(5), 40, 40)
    for a, b in zip(J.render_sphere_view(pose, K, 40, 40),
                    P.render_sphere_view(pose, K, 40, 40)):
        same(a, b)


@pytest.mark.parametrize("scene", ["sphere", "blobs", "room", "pan"])
@pytest.mark.parametrize("seed,rfn,h,w", [(0, 3, 32, 32), (7, 2, 40, 56)])
def test_make_sphere_scene_and_query(scene, seed, rfn, h, w):
    """``make_sphere_scene`` and ``make_query`` with ``spheres`` and
    ``depth_range`` (``named_scene``'s), random and full-image queries."""
    spheres, depth_range = P.named_scene(scene)
    rng_j, rng_p = np.random.RandomState(seed), np.random.RandomState(seed)
    same_dicts(J.make_sphere_scene(rng_j, rfn, h, w, spheres, depth_range),
               P.make_sphere_scene(rng_p, rfn, h, w, spheres, depth_range))
    for full in (False, True):
        same_dicts(J.make_query(rng_j, h, w, 17, full, spheres, depth_range),
                   P.make_query(rng_p, h, w, 17, full, spheres,
                                depth_range))


def test_named_scene():
    """The tools' scenes by name: the JAX tools build them inline."""
    assert P.named_scene("sphere") == (J.UNIT_SPHERE, J.DEPTH_RANGE)
    assert P.named_scene("blobs") == (
        J.make_blob_spheres(np.random.RandomState(42)), J.DEPTH_RANGE)
    assert P.named_scene("room") == (
        J.make_room_spheres(np.random.RandomState(42)), J.ROOM_DEPTH_RANGE)
    assert P.named_scene("pan") == (J.make_pan_scene_spheres(),
                                    J.DEPTH_RANGE)


@pytest.mark.parametrize("seed", [0, 9])
def test_defaults_unchanged(seed):
    """The defaults give the unit-sphere arrays every earlier path
    renders: the JAX package's defaults, and the explicit unit sphere."""
    for args in ((), (P.UNIT_SPHERE, P.DEPTH_RANGE)):
        rng_j, rng_p = (np.random.RandomState(seed),
                        np.random.RandomState(seed))
        same_dicts(J.make_sphere_scene(rng_j, 3, 24, 32),
                   P.make_sphere_scene(rng_p, 3, 24, 32, *args))
        same_dicts(J.make_query(rng_j, 24, 32, 11, True),
                   P.make_query(rng_p, 24, 32, 11, True, *args))
    scene = P.make_sphere_scene(np.random.RandomState(seed), 2, 16, 16)
    assert (scene["depth_range"] == np.float32([2.5, 5.5])).all()


def test_trajectory_geometry():
    """``look_at_pose`` and ``sphere_in_frustum`` against the JAX tool's."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    import check_trajectory_escalation as T
    rng = np.random.RandomState(3)
    K = np.array([[96.0, 0, 40], [0, 96.0, 40], [0, 0, 1]], np.float32)
    for _ in range(20):
        cam, target = rng.randn(3) * 4, rng.randn(3) * 0.5
        pose = P.look_at_pose(cam, target)
        same(pose, T.look_at_pose(cam, target))
        for s in J.make_pan_scene_spheres()[:6]:
            for margin in (0.0, 12.0):
                assert (P.sphere_in_frustum(pose, K, 80, 80,
                                            np.asarray(s[0]), s[1], margin)
                        == T.sphere_in_frustum(pose, K, 80, 80,
                                               np.asarray(s[0]), s[1],
                                               margin))
    same(P.look_at_pose(np.array([0.0, 0, 4]), np.zeros(3)),
         T.look_at_pose(np.array([0.0, 0, 4]), np.zeros(3)))


def test_pan_scene_separable_from_shell():
    """``tests/test_data.py::test_pan_scene_separable_from_shell`` on the
    port's geometry: some radius-4 shell camera frames the anchor while
    every rod sphere projects outside the image (12 px margin), and
    centering the rods brings them in."""
    from neuray_tpu_torch.check_trajectory_escalation import start_camera
    spheres = P.make_pan_scene_spheres()
    anchor, rod = spheres[0], spheres[1:]
    assert anchor[1] == 0.5 and all(s[1] == 0.10 for s in rod)
    h = w = 400
    K = np.array([[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]],
                 np.float32)
    t0 = np.asarray(anchor[0], np.float64)
    rs = np.random.RandomState(7)
    found = None
    for _ in range(512):
        d = rs.randn(3)
        d /= np.linalg.norm(d)
        c = d * P.RADIUS
        pose0 = P.look_at_pose(c, t0)
        if (P.sphere_in_frustum(pose0, K, h, w, np.asarray(anchor[0]),
                                anchor[1])
                and not any(P.sphere_in_frustum(
                    pose0, K, h, w, np.asarray(s[0]), s[1], margin=12.0)
                    for s in rod)):
            found = c
            break
    assert found is not None, "no shell camera separates anchor from rod"
    same(found, start_camera(anchor, rod, K, h, w))
    pose1 = P.look_at_pose(found, np.array([-1.25, 0.0, 0.0]))
    assert any(P.sphere_in_frustum(pose1, K, h, w, np.asarray(s[0]), s[1])
               for s in rod)
