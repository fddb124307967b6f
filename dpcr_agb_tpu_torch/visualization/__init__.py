"""Prediction export of the port: GeoPackage point layers and the
Visualizer's csv / gpkg / ply writers; and the browsing of run
directories (experiment_manager)."""
