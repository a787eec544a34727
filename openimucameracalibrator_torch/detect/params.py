"""Detector-parameter config files.

A copy of ``detect/params.py`` of the JAX package (host code). The
reference reads aruco detector parameters from an OpenCV-YAML file
(reference src/utils/utils.cc:43-75, consuming
resource/charuco_detector_params.yml) and passes the path via the
``--aruco_detector_params`` flag of extract_board_to_json. This module is
the framework equivalent: it parses that exact flat OpenCV-YAML schema
(plus plain json with the same keys) WITHOUT needing OpenCV or PyYAML,
and maps the keys onto the native detector's option dataclasses
(quads.MarkerDetectorOptions / charuco.CharucoDetectorOptions).

Key mapping (OpenCV aruco parameter -> native option):
  adaptiveThreshWinSize[Max]            -> threshold_radius (= win // 2)
  adaptiveThreshConstant                -> threshold_c
  minMarkerPerimeterRate                -> min_area_px
      (a square of perimeter p has area (p/4)^2; rate is relative to the
       larger image dimension, evaluated when the image size is known —
       pass image_size, else the native default stands)
  maxMarkerPerimeterRate                -> max_area_frac (same square model)
  markerBorderBits                      -> border_bits
  cornerRefinementWinSize               -> charuco subpix_win ONLY: the
      native marker-quad refinement keeps its own window (a wide window
      around a marker corner of a dense board reaches the neighboring
      checker corners and drags the quad off the marker — measured: 40 ->
      16 decoded markers at win 6 on a rendered 10x8 board)
  perspectiveRemovePixelPerCell         -> cell_oversample (capped at 5:
      the native sampler integrates cell interiors; more than ~5x
      oversampling changes nothing)
Unmapped keys (polygonal approximation, Otsu, error-correction rate, ...)
configure OpenCV internals with no native analog; they are parsed and
returned in ``extras`` so the OpenCV backend can still consume them and
nothing is silently dropped.
"""

from __future__ import annotations

import dataclasses
import json
import os

from openimucameracalibrator_torch.detect import charuco as charuco_mod
from openimucameracalibrator_torch.detect import quads as quads_mod

# Keys the reference's ReadDetectorParameters consumes (utils.cc:47-66).
_REFERENCE_KEYS = {
    "nmarkers", "adaptiveThreshWinSizeMin", "adaptiveThreshWinSizeMax",
    "adaptiveThreshWinSizeStep", "adaptiveThreshWinSize",
    "adaptiveThreshConstant", "minMarkerPerimeterRate",
    "maxMarkerPerimeterRate", "polygonalApproxAccuracyRate",
    "minCornerDistance", "minCornerDistanceRate", "minDistanceToBorder",
    "minMarkerDistance", "minMarkerDistanceRate", "cornerRefinementMethod",
    "cornerRefinementWinSize", "cornerRefinementMaxIterations",
    "cornerRefinementMinAccuracy", "markerBorderBits",
    "perspectiveRemovePixelPerCell", "perspectiveRemoveIgnoredMarginPerCell",
    "maxErroneousBitsInBorderRate", "minOtsuStdDev", "errorCorrectionRate",
}


def parse_opencv_yaml(path: str) -> dict:
    """Parse a flat OpenCV-YAML (or json) file into {key: number}.

    OpenCV FileStorage YAML for detector params is strictly flat
    ``key: value`` lines with optional comments — a full YAML parser is
    not needed (and PyYAML must not become a dependency)."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("{"):
        return {str(k): v for k, v in json.loads(text).items()}
    out: dict = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or line.startswith("%YAML") or line == "---":
            continue
        if ":" not in line:
            continue
        key, _, val = line.partition(":")
        key, val = key.strip().strip('"'), val.strip().strip('"')
        if not key or not val:
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


@dataclasses.dataclass
class DetectorParams:
    marker: quads_mod.MarkerDetectorOptions
    charuco: charuco_mod.CharucoDetectorOptions
    extras: dict  # parsed-but-unmapped keys (OpenCV-internal knobs)
    unknown: dict  # keys outside the reference schema entirely


def load_detector_params(path: str,
                         image_size: tuple | None = None) -> DetectorParams:
    """Detector options from a config file (OpenCV-YAML or json).

    ``image_size`` (w, h) resolves the perimeter-rate keys, which OpenCV
    defines relative to the larger image dimension."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    raw = parse_opencv_yaml(path)
    marker = quads_mod.MarkerDetectorOptions()
    ch = charuco_mod.CharucoDetectorOptions()
    extras, unknown = {}, {}

    win = raw.get("adaptiveThreshWinSize",
                  raw.get("adaptiveThreshWinSizeMax"))
    if win is not None:
        marker.threshold_radius = max(1, int(win) // 2)
    if "adaptiveThreshConstant" in raw:
        marker.threshold_c = float(raw["adaptiveThreshConstant"])
    dim = max(image_size) if image_size else None
    if "minMarkerPerimeterRate" in raw and dim:
        side = float(raw["minMarkerPerimeterRate"]) * dim / 4.0
        marker.min_area_px = max(4.0, side * side)
    if "maxMarkerPerimeterRate" in raw and image_size:
        side = float(raw["maxMarkerPerimeterRate"]) * dim / 4.0
        marker.max_area_frac = min(
            1.0, side * side / (image_size[0] * image_size[1]))
    if "markerBorderBits" in raw:
        marker.border_bits = int(raw["markerBorderBits"])
    if "cornerRefinementWinSize" in raw:
        ch.subpix_win = int(raw["cornerRefinementWinSize"])
    if "perspectiveRemovePixelPerCell" in raw:
        marker.cell_oversample = max(1, min(5, int(
            raw["perspectiveRemovePixelPerCell"])))

    mapped = {"adaptiveThreshWinSize", "adaptiveThreshWinSizeMax",
              "adaptiveThreshConstant", "minMarkerPerimeterRate",
              "maxMarkerPerimeterRate", "markerBorderBits",
              "cornerRefinementWinSize", "perspectiveRemovePixelPerCell"}
    for k, v in raw.items():
        if k in mapped:
            continue
        (extras if k in _REFERENCE_KEYS else unknown)[k] = v
    ch.marker = marker
    return DetectorParams(marker=marker, charuco=ch, extras=extras,
                          unknown=unknown)
