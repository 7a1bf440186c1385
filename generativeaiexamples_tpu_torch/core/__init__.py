"""Small shared pieces: logging and device resolution."""
