"""Device-resident packed store and the episodic sampler."""
