"""Small sizes for running the harness on the CPU: a Qwen2-shaped config
and the cells' files cut to it. The cells' own sizes run on the card."""

import copy
import time

from dtxbench.harness import env, runner, spec

env.prepare()

CONFIG = {"model_type": "qwen2", "hidden_size": 64,
          "intermediate_size": 128, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 4,
          "vocab_size": 512, "max_position_embeddings": 4096,
          "rope_theta": 1e6, "rms_norm_eps": 1e-6,
          "tie_word_embeddings": False}


# serving is judged on logit gaps, which scale with the width: a wider
# model keeps an altered token's gap as far above the limit as at size
SERVE_CONFIG = dict(CONFIG, hidden_size=1024, intermediate_size=2048,
                    num_attention_heads=8, num_key_value_heads=8)


def train_cell(cell):
    wl = copy.deepcopy(spec.workload(cell))
    wl["job"].update(batch=2, block=128, total_steps=10)
    tr = dict(spec.traffic(wl["traffic"]), documents=40,
              length={"dist": "lognormal", "median": 40, "sigma": 0.8,
                      "min": 8, "max": 128})
    return wl, tr


def serve_cell(cell):
    wl = copy.deepcopy(spec.workload(cell))
    # a pool several times what the prefix cache can pin, as the cell's
    wl["engine"].update(slots=4, max_seq_len=256, kv_blocks=128,
                        prefix_cache=4)
    wl.update(check_tokens=40, traced_seconds=0.5)
    tr = dict(spec.traffic(wl["traffic"]), rate=3.0, ramp_s=1.5,
              greedy_share=0.5,
              prompt={"dist": "lognormal", "median": 40, "sigma": 0.5,
                      "min": 8, "max": 100},
              output={"dist": "lognormal", "median": 6, "sigma": 0.5,
                      "min": 4, "max": 12})
    return wl, tr


def run(cell, seed=2 ** 31 + 5, seconds=None, trace=False, fault=None,
        control=False):
    train = cell.startswith("train")
    seconds = seconds or (1.0 if train else 3.0)
    wl, tr = (train_cell if train else serve_cell)(cell)
    return runner.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                           device="cpu",
                           config=CONFIG if train else SERVE_CONFIG,
                           workload=wl,
                           traffic=tr, fault=fault, control=control)
