from .builder import Tracks, build_tracks, observations_table, tracks_in_views

__all__ = ["Tracks", "build_tracks", "observations_table", "tracks_in_views"]
