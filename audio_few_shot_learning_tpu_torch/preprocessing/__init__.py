"""Audio decoding for the raw-audio predict path (offline preprocessing
CLIs come with a later slice)."""
