"""Normalization presets (mean, std) by name, shared by the device
transforms (`data/transforms.py`) and the training data layer's host
transform (`data/datasets.py`); torch-free, so that spawned loader workers
load without torch."""

PRESETS = {
    # name: (mean, std)
    "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "clip": ((0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)),
    "vit": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    "efficientnet": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
}
