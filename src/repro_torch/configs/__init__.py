"""The paper's own experiment configurations, mirrored for the port."""
