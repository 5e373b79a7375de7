"""Mitsuba camera XML parsing and viewpoint binning (counterpart of
``genre_shapehd_tpu/utils/cam_para.py``; numpy): azimuth and elevation
from the lookAt origin, object rotation matrices, angle <-> one-hot
bins."""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, Tuple

import numpy as np


def read_cam_para_from_xml(xml_name: str) -> Tuple[float, float]:
    """(azimuth, elevation) in radians of the sensor's lookAt origin."""
    root = ET.parse(xml_name).getroot()
    sensors = root.findall("sensor")
    assert len(sensors) == 1
    lookat = sensors[0].find("transform").find("lookAt")
    origin = np.array(lookat.get("origin").split(","), dtype=np.float32)
    x, y, z = origin
    elevation = float(np.arctan2(y, np.sqrt(x ** 2 + z ** 2)))
    azimuth = float(np.arctan2(x, z) + np.pi)
    if azimuth >= np.pi:
        azimuth -= 2 * np.pi
    assert -np.pi <= azimuth <= np.pi
    assert -np.pi / 2 <= elevation <= np.pi / 2
    return azimuth, elevation


def _floats(text: str) -> np.ndarray:
    return np.array(text.split(","), dtype=np.float32)


def raw_camparam_from_xml(path: str, pose: str = "lookAt") -> Dict:
    tree = ET.parse(path)
    elm = tree.find("./sensor/transform/" + pose)
    attrs = elm.attrib
    out = {
        "origin": _floats(attrs["origin"]),
        "target": _floats(attrs["target"]),
        "up": _floats(attrs["up"]),
        "height": int(tree.find(
            "./sensor/film/integer[@name='height']").attrib["value"]),
        "width": int(tree.find(
            "./sensor/film/integer[@name='width']").attrib["value"]),
    }
    return out


def get_object_rotation(xml_path: str, style: str = "zup") -> np.ndarray:
    """Object rotation from the camera lookAt (``zup``: in a z-up frame)."""
    assert style in ("yup", "zup")
    cam = raw_camparam_from_xml(xml_path)
    rx = cam["target"] - cam["origin"]
    rz = np.cross(rx, cam["up"])
    ry = np.cross(rz, rx)
    rx = rx / np.linalg.norm(rx)
    ry = ry / np.linalg.norm(ry)
    rz = rz / np.linalg.norm(rz)
    r = np.array([rx, ry, rz])
    if style == "zup":
        r_coord = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], dtype=float)
        r = r_coord @ r @ r_coord.T
    return r


def _divide_into_section(angle, num, lo, hi) -> np.ndarray:
    out = np.zeros(num)
    size = (hi - lo) / num
    angle = angle - size / 2
    if angle < lo:
        angle += hi - lo
    out[int((angle - lo) / size)] = 1
    return out


def _section_to_angle(idx, num, lo, hi) -> float:
    size = (hi - lo) / num
    angle = (idx + 0.5) * size + lo + size / 2
    if angle > hi:
        angle -= hi - lo
    return angle


def azimuth_to_onehot(azimuth, num):
    return _divide_into_section(azimuth, num, -np.pi, np.pi)


def elevation_to_onehot(elevation, num):
    return _divide_into_section(elevation, num, -np.pi / 2, np.pi / 2)


def onehot_to_azimuth(v, num):
    return _section_to_angle(int(np.argmax(v)), num, -np.pi, np.pi)


def onehot_to_elevation(v, num):
    return _section_to_angle(int(np.argmax(v)), num, -np.pi / 2, np.pi / 2)
