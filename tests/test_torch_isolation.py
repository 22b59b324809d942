"""The port stands alone: no module of ``chainermn_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax, optax or the JAX package, importing
the package loads no subpackage, and the serving, LM training and image
training paths (synchronized BatchNorm over the hierarchical
communicator and the int8 wire with error feedback among them; the
other image archs; the prefetching input pipeline, the synchronized and
multi-node iterators and the checkpointer with a resume; the seq2seq
chain and pipeline steps) run with those modules made unimportable."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "optax", "chainermn_tpu"}


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    root = os.path.join(REPO, "chainermn_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "_build")
        paths += [os.path.join(dirpath, f) for f in sorted(filenames)
                  if f.endswith(".py")]
    return paths


def test_no_banned_imports_in_port_sources():
    found = []
    paths = _port_sources()
    assert len(paths) > 10 and os.path.isfile(paths[0])
    for path in paths:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in BANNED:
                    found.append(f"{os.path.relpath(path, REPO)}:"
                                 f"{node.lineno} imports {name}")
    assert not found, "\n".join(found)


_BLOCKED_RUN = r"""
import importlib.abc, sys

BANNED = {banned!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"blocked: {{name}}")
        return None

sys.meta_path.insert(0, Block())

import chainermn_tpu_torch
assert "chainermn_tpu_torch.ops" not in sys.modules, "facade is not lazy"

from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.serving import ContinuousBatcher, DecodeEngine, Request

lm = TransformerLM(64, 32, 4, 2, max_len=64, seed=0)
eng = DecodeEngine(lm, capacity=2, page_size=8, attention_impl="flash",
                   device="cpu")
out = ContinuousBatcher(eng).serve([Request([1, 2, 3], 4),
                                    Request([4, 5], 3)])
assert [r.state for r in out] == ["done", "done"]

import numpy as np
import torch
import torch.distributed as dist
from chainermn_tpu_torch.models import flax_ordered_parameters, lm_loss
from chainermn_tpu_torch.ops import flash_attention_fn

dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                        world_size=1)
comm = chainermn_tpu_torch.create_communicator("pure_nccl")
lm = TransformerLM(64, 64, 1, 1, max_len=16, attention_fn=flash_attention_fn())
opt = chainermn_tpu_torch.create_multi_node_optimizer(torch.optim.AdamW(
    [p for _, p in flax_ordered_parameters(lm)], lr=1e-3), comm)
step = chainermn_tpu_torch.build_train_step(
    comm, lambda t: lm_loss(lm(t), t), opt)
data = chainermn_tpu_torch.scatter_dataset(
    np.arange(64).reshape(4, 16) % 64, comm, shuffle=True, seed=0)
toks = torch.from_numpy(np.stack([data[i] for i in range(2)]))
assert np.isfinite(float(step(toks)["loss"]))

from chainermn_tpu_torch.comm_wire import WireConfig
from chainermn_tpu_torch.links import create_mnbn_model
from chainermn_tpu_torch.models import ResNet18
from chainermn_tpu_torch.ops.losses import softmax_cross_entropy

hier = chainermn_tpu_torch.create_communicator("hierarchical")
net = create_mnbn_model(ResNet18(num_classes=4, num_filters=4,
                                 dtype=torch.float32), hier)
opt = chainermn_tpu_torch.create_multi_node_optimizer(
    torch.optim.SGD([p for _, p in flax_ordered_parameters(net)], lr=0.1,
                    momentum=0.9),
    hier, wire=WireConfig("int8", error_feedback=True))
step = chainermn_tpu_torch.build_train_step(
    hier, lambda b: softmax_cross_entropy(net(b[0]), b[1]), opt,
    model_state=list(net.buffers()))
assert np.isfinite(float(step((torch.randn(2, 16, 16, 3),
                               torch.tensor([0, 1])))["loss"]))
assert opt.wire_residual and hier.mesh_shape == {{"mn_inter": 1,
                                                  "mn_intra": 1}}
dist.destroy_process_group()

from chainermn_tpu_torch.examples import train_imagenet, train_mnist

log = train_mnist.main(["--device", "cpu", "--epoch", "1", "--n-train", "256",
                        "--n-test", "64", "--batchsize", "64", "--unit", "32",
                        "--allreduce-grad-dtype", "bfloat16"])
assert np.isfinite(log[-1]["loss"])
log = train_imagenet.main(["--device", "cpu", "--arch", "resnet18",
                           "--image-size", "32", "--n-train", "8",
                           "--n-val", "8", "--batchsize", "8",
                           "--num-classes", "10"])
assert np.isfinite(log[-1]["val/loss"])
log = train_imagenet.main(["--device", "cpu", "--arch", "resnet18",
                           "--image-size", "32", "--n-train", "8",
                           "--n-val", "8", "--batchsize", "8",
                           "--num-classes", "10", "--mnbn",
                           "--communicator", "hierarchical"])
assert np.isfinite(log[-1]["val/loss"])
for arch in ("alex", "googlenet", "googlenetbn", "nin", "vgg16"):
    for epochs in ("1", "2"):
        log = train_imagenet.main(["--device", "cpu", "--arch", arch,
                                   "--image-size", "96", "--n-train", "8",
                                   "--n-val", "4", "--batchsize", "4",
                                   "--num-classes", "10", "--lr", "0.01",
                                   "--checkpoint", "iso_" + arch,
                                   "--epoch", epochs])
    assert log[-1]["iteration"] == 5 and np.isfinite(log[-1]["val/loss"])

from chainermn_tpu_torch.datasets import (create_empty_dataset, rescatter,
                                          scatter_dataset_all)
from chainermn_tpu_torch.iterators import (
    SerialIterator, create_multi_node_iterator, create_synchronized_iterator,
    device_placer, prefetch_to_device)

dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                        world_size=1)
comm = chainermn_tpu_torch.create_communicator("pure_nccl")
data = [(np.full(2, i, np.float32), np.int32(i)) for i in range(12)]
it = create_multi_node_iterator(create_synchronized_iterator(
    SerialIterator(data, 4), comm), comm)
it = prefetch_to_device(it, device_placer("cpu"))
assert next(it)[0].shape == (4, 2) and len(create_empty_dataset(data)) == 12
shards = scatter_dataset_all(data, comm, shuffle=True)
assert len(rescatter(shards[0], (1.0,))) == 12
ckpt = chainermn_tpu_torch.create_multi_node_checkpointer("iso", comm,
                                                          use_async=True)
ckpt.save(1, {{"x": torch.ones(3), "it": it.serialize()}})
assert ckpt.resume()[0] == 1
ckpt.finalize()
dist.destroy_process_group()

from chainermn_tpu_torch.examples import train_seq2seq  # noqa: F401
from chainermn_tpu_torch.examples.train_seq2seq_mp1 import make_chain
from chainermn_tpu_torch.models import seq2seq_loss
from chainermn_tpu_torch.parallel import (build_pipeline_train_step,
                                          place_stage_params)
from chainermn_tpu_torch.parallel.seq2seq_pipeline import (
    Seq2SeqStages, carry_width, pack_batch, pipeline_loss, union_params)

dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                        world_size=1)
comm = chainermn_tpu_torch.create_communicator("pure_nccl")
src = torch.randint(3, 16, (4, 4))
chain = make_chain(comm, 16, 8, 1)
opt = chain.optimizer(torch.optim.Adam)
assert np.isfinite(float(chain.value_and_grad(seq2seq_loss)([src, src], src)))
opt.step()
stages = Seq2SeqStages(comm, 16, 8, 1, 4)
sp = place_stage_params(union_params(stages.enc, stages.dec, 1), comm)
step = build_pipeline_train_step(comm, stages, pipeline_loss,
                                 torch.optim.Adam(sp.values()), n_micro=2)
packed = pack_batch(src, src, 2, carry_width(8, 1, 4))
assert np.isfinite(float(step(sp, (packed, None))["loss"]))
dist.destroy_process_group()
assert not any(m.split(".")[0] in BANNED for m in sys.modules)
print("ok")
"""


def test_port_imports_and_serves_with_jax_blocked(tmp_path):
    """The serving path, a training step, the MNIST and ImageNet
    examples' twins (which write their logs and checkpoints under the
    working directory; every arch, each resumed once), the iterators,
    the async checkpointer, a seq2seq chain step (the model-parallel
    twin's chain) and a pipeline step run with JAX and the JAX package
    unimportable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # one intra-op thread: the suite's workers share the host's cores
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN.format(banned=BANNED)],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("ok")
