"""One module a kind of traffic mix: its set-up, window and check."""
