"""Prediction export of the port: GeoPackage point layers and the
Visualizer's csv / gpkg / ply writers."""
