"""Full-scene tiled inference."""
