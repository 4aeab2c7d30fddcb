"""Geometry: SE(3) maps, Schur bundle adjustment, pose graph."""
