"""Scenes, costs and the fused solve kernel."""
