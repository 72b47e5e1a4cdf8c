"""Training: the contrastive descriptor trainer, its checkpoints and
snapshots, and the video-score (VED) trainer."""
