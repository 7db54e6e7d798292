"""The port's polygon fill (pda_torch/data/builders/coco.py ``fill_poly``)
against ``cv2.fillPoly`` on the CPU, bit for bit: hypothesis draws frames
and sets of polygons (one point to a dozen, several at once, overlapping,
self-intersecting, degenerate, inside the frame, on its border, and far
outside it); hand-made cases name the rules one by one (inclusive edges and
vertices, one-pixel-high and collinear polygons, overlap by the even-odd
rule, clipping); and ``polygons_to_mask`` runs with cv2 blocked."""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from pda_torch.data.builders import coco

REPO = os.path.join(os.path.dirname(__file__), "..")


def cv2_fill(shape, polygons):
    mask = np.zeros(shape, np.uint8)
    cv2.fillPoly(mask, [np.asarray(p, np.int32).reshape(-1, 2) for p in polygons], 1)
    return mask


def port_fill(shape, polygons):
    mask = np.zeros(shape, np.uint8)
    coco.fill_poly(mask, [np.asarray(p, np.int32).reshape(-1, 2) for p in polygons])
    return mask


@st.composite
def scenes(draw, reach):
    h = draw(st.integers(1, 48))
    w = draw(st.integers(1, 48))
    pad = draw(reach)
    point = st.tuples(st.integers(-pad, w + pad), st.integers(-pad, h + pad))
    polygons = draw(st.lists(st.lists(point, min_size=1, max_size=12), min_size=1, max_size=4))
    return (h, w), polygons


SETTINGS = settings(max_examples=400, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])


@SETTINGS
@given(scenes(st.just(0)))
def test_fill_matches_cv2_inside_the_frame(scene):
    shape, polygons = scene
    assert np.array_equal(port_fill(shape, polygons), cv2_fill(shape, polygons))


@SETTINGS
@given(scenes(st.sampled_from([1, 2, 5, 20])))
def test_fill_matches_cv2_near_the_frame(scene):
    shape, polygons = scene
    assert np.array_equal(port_fill(shape, polygons), cv2_fill(shape, polygons))


@SETTINGS
@given(scenes(st.sampled_from([100, 5000, 200_000])))
def test_fill_matches_cv2_far_outside(scene):
    shape, polygons = scene
    assert np.array_equal(port_fill(shape, polygons), cv2_fill(shape, polygons))


HAND = {
    "triangle": ((20, 24), [[(2, 3), (20, 8), (6, 18)]]),
    "triangle_reversed": ((20, 24), [[(6, 18), (20, 8), (2, 3)]]),
    "one_pixel_high": ((10, 20), [[(2, 4), (15, 4), (9, 4)]]),
    "one_pixel": ((6, 6), [[(3, 2)]]),
    "two_points": ((12, 12), [[(1, 1), (9, 7)]]),
    "collinear": ((16, 16), [[(1, 1), (5, 5), (9, 9), (13, 13)]]),
    "vertical_sliver": ((12, 12), [[(5, 1), (6, 10), (5, 10)]]),
    "bow_tie": ((20, 20), [[(2, 2), (17, 17), (17, 2), (2, 17)]]),
    "star": ((30, 30), [[(15, 1), (20, 28), (2, 10), (28, 10), (10, 28)]]),
    "overlapping": ((24, 24), [[(2, 2), (16, 2), (16, 16), (2, 16)],
                               [(8, 8), (21, 8), (21, 21), (8, 21)]]),
    "nested": ((24, 24), [[(1, 1), (22, 1), (22, 22), (1, 22)], [(6, 6), (16, 6), (11, 16)]]),
    "on_the_border": ((10, 14), [[(0, 0), (14, 0), (14, 10), (0, 10)]]),
    "clipped_left_top": ((16, 16), [[(-6, -6), (8, 28), (0, -9)]]),
    "clipped_right": ((10, 2), [[(1, 6), (2, 10)]]),
    "outside_right": ((18, 14), [[(46, 37), (-12, -30)]]),
    "outside_left": ((11, 4), [[(0, 11), (-2, -2)]]),
    "far_outside": ((16, 16), [[(-9000, -9000), (9000, -8000), (100, 9000)]]),
}


@pytest.mark.parametrize("case", sorted(HAND))
def test_fill_hand_made_cases(case):
    shape, polygons = HAND[case]
    ref = cv2_fill(shape, polygons)
    assert np.array_equal(port_fill(shape, polygons), ref)
    if case in ("triangle", "overlapping", "on_the_border", "one_pixel_high"):
        assert ref.any()


def test_fill_edges_and_vertices_are_inclusive():
    """Every vertex of an in-frame polygon is filled, and a square's four
    sides are part of it."""
    mask = port_fill((12, 12), [[(2, 3), (9, 3), (9, 8), (2, 8)]])
    want = np.zeros((12, 12), np.uint8)
    want[3:9, 2:10] = 1
    assert np.array_equal(mask, want)


def test_polygons_to_mask_matches_pda():
    """pda's polygons_to_mask (cv2) on LIVECell-like float polygons, some
    with fewer than three points (dropped), some touching the border."""
    from pda.data.builders.coco import polygons_to_mask as pda_polygons

    rng = np.random.default_rng(0)
    h, w = 60, 80
    for _ in range(30):
        polys = []
        for _ in range(int(rng.integers(1, 4))):
            k = int(rng.integers(1, 12))
            c = rng.uniform(0, 1, 2) * (w, h)
            ang = np.sort(rng.uniform(0, 2 * np.pi, k))
            r = rng.uniform(2, 30, k)
            pts = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)
            polys.append(np.clip(pts, 0, (w, h)).ravel().tolist())
        port = coco.polygons_to_mask(polys, h, w)
        assert port.dtype == bool and np.array_equal(port, pda_polygons(polys, h, w))


def test_fill_refuses_coordinates_beyond_its_range():
    with pytest.raises(ValueError, match="beyond"):
        port_fill((4, 4), [[(0, 0), (2**21, 3), (1, 3)]])


def test_polygons_to_mask_runs_without_cv2(tmp_path):
    """The rasterization needs no cv2: a subprocess with it blocked."""
    polys = [[2.2, 3.1, 20.7, 8.4, 6.5, 18.9], [1.0, 2.0]]
    script = (
        "import sys, json\n"
        "sys.modules['cv2'] = None\n"
        "from pda_torch.data.builders.coco import polygons_to_mask\n"
        f"m = polygons_to_mask({polys!r}, 20, 24)\n"
        "print(json.dumps(m.astype(int).tolist()))\n"
        "assert 'cv2' not in sys.modules or sys.modules['cv2'] is None\n"
    )
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    got = np.array(json.loads(out.stdout.strip().splitlines()[-1]), np.uint8)
    from pda.data.builders.coco import polygons_to_mask as pda_polygons

    assert np.array_equal(got.astype(bool), pda_polygons(polys, 20, 24))
