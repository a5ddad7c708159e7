"""Small host-side helpers: paths, JSONL records, phase timing."""
