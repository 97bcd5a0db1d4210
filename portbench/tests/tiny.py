"""Tiny configurations (the port's TINY_UNET, TINY_VAE, TINY_CLIP_TEXT and
TINY_CLIP_VISION, in the published config.json layout; the text vocabulary
kept at CLIP's 49,408 so that the end-of-text id exists) and small traffic,
so that a whole run fits a CPU test."""
import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

TEXT = {"hidden_act": "quick_gelu", "hidden_size": 32, "intermediate_size": 64, "layer_norm_eps": 1e-05,
        "max_position_embeddings": 77, "num_attention_heads": 2, "num_hidden_layers": 2, "projection_dim": 16,
        "vocab_size": 49408}

SD = {
    "unet": {"attention_head_dim": 2, "block_out_channels": [32, 64], "cross_attention_dim": 32,
             "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"], "flip_sin_to_cos": True, "freq_shift": 0,
             "in_channels": 4, "layers_per_block": 1, "norm_num_groups": 8, "out_channels": 4, "sample_size": 8,
             "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"]},
    "vae": {"block_out_channels": [16, 32], "in_channels": 3, "latent_channels": 4, "layers_per_block": 1,
            "norm_num_groups": 4, "out_channels": 3, "scaling_factor": 0.18215},
    "text_encoder": TEXT,
    "scheduler": {"beta_end": 0.012, "beta_schedule": "scaled_linear", "beta_start": 0.00085,
                  "num_train_timesteps": 1000, "prediction_type": "epsilon"},
}

CLIP = {
    "projection_dim": 16,
    "text_config": TEXT,
    "vision_config": {"hidden_act": "quick_gelu", "hidden_size": 32, "image_size": 64, "intermediate_size": 64,
                      "layer_norm_eps": 1e-05, "num_attention_heads": 2, "num_channels": 3, "num_hidden_layers": 2,
                      "patch_size": 8, "projection_dim": 16},
}


def workload(cell: str, **traffic):
    with open(HERE / "workloads" / f"{cell}.json") as f:
        w = json.load(f)
    w = copy.deepcopy(w)
    w["traffic"].update(traffic)
    return w
