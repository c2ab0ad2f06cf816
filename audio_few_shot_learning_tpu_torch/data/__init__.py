"""Device-resident packed stores, the episodic sampler and the
reference-layout dataset loader."""
