"""Model math and blocks for the attention family at tp = 1."""
