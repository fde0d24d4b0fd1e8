"""Port parity: the mesh spec and the partition rules of the parallelism
slice against the JAX package, with no process group: ``parse_mesh_spec``
over a table of specs and device counts (errors included), the rules on
the port's names for three families against ``partition_specs`` on the
same flax trees (mapped through the importer's key names, a torch
``Linear`` weight being the flax kernel transposed), the divisibility
downgrade and its warning, and the FSDP size threshold."""

import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from vit_torch_tpu.models.zoo import VisionModelZoo as JaxZoo
from vit_torch_tpu.parallel import mesh as jax_mesh
from vit_torch_tpu.parallel import partition as jax_partition
from vit_torch_tpu_torch.checkpoint.jax_import import _torch_key
from vit_torch_tpu_torch.parallel import mesh, partition
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

SPECS = ["", "data=4,model=2", "data=-1,model=2", "data=2,pipe=4",
         "seq=8", "data=2,seq=2,model=2", "model=-1", "data=3", "bogus=8",
         "data=-1,model=-1", "data=3,model=-1", "pipe=2"]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("spec", SPECS)
def test_parse_mesh_spec_matches_jax(spec, n):
    try:
        want = jax_mesh.parse_mesh_spec(spec, n)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            mesh.parse_mesh_spec(spec, n)
        return
    assert mesh.parse_mesh_spec(spec, n) == want


def test_rank_groups_are_the_jax_mesh_layout():
    """The rank of JAX mesh position (d, m, s, p) is its row-major index:
    the groups along each axis are the JAX mesh's rows along it."""
    shape = (2, 2, 1, 2)
    ranks = np.arange(8).reshape(shape)
    assert mesh.rank_groups(shape, ("model",)) == [
        list(ranks[d, :, 0, p]) for d in range(2) for p in range(2)]
    assert mesh.rank_groups(shape, ("data", "pipe")) == [
        list(ranks[:, m, 0, :].reshape(-1)) for m in range(2)]


def _flax_to_port(path: str, spec, ndim: int):
    """The port's name and per-dim axes of a flax leaf's spec."""
    key = _torch_key(path)
    leaf = key.rsplit(".", 1)[-1]
    axes = list(spec) + [None] * (ndim - len(spec))
    if key.endswith("patch_embed.bias") or key.endswith("patch_embed.kernel"):
        # the ViT patch embedding's kernel becomes a (D, C, p, p) conv
        # weight: its axes are compared apart
        return key.replace("patch_embed.", "patch_embed.proj.").replace(
            "kernel", "weight"), tuple(axes)
    if leaf == "kernel":
        key = key[:-len("kernel")] + "weight"
        axes = axes[::-1]
    elif leaf == "scale":
        key = key[:-len("scale")] + "weight"
    return key, tuple(axes)


@pytest.mark.parametrize("arch,size", [("vit_tiny_test", 32),
                                       ("cait_test", 32),
                                       ("swin_test", 32)])
def test_partition_rules_match_jax(arch, size):
    """Which parameter shards on which axis, by the rules alone (the JAX
    ``partition_specs``; the port's modules then cut local heads, see
    ``parallel/partition.py``)."""
    zm = JaxZoo.get_model(arch, classifier=[10], image_size=size,
                          dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: zm.init(jax.random.PRNGKey(0),
                                            image_size=size))["params"]
    specs = jax_partition.partition_specs(shapes)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    leaves = dict((jax.tree_util.keystr(p), s) for p, s in
                  jax.tree_util.tree_flatten_with_path(shapes)[0])
    want = {}
    for path, spec in flat:
        name = ".".join(str(k.key) for k in path)
        key, axes = _flax_to_port(name, spec,
                                  len(leaves[jax.tree_util.keystr(path)]
                                      .shape))
        want[key] = axes
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    port = VisionModelZoo.get_model(arch, classifier=[10], image_size=size,
                                    device="meta")
    port_shapes = {n: tuple(p.shape)
                   for n, p in port.model.named_parameters()}
    got = partition.partition_specs(port_shapes)
    sharded = {k for k, a in want.items() if any(a)}
    assert sharded, "the rules shard nothing"
    for name, spec in got.items():
        axes = tuple(spec) + (None,) * (len(port_shapes[name]) - len(spec))
        if name in want and name.endswith("patch_embed.proj.weight"):
            assert any(axes) == any(want[name]), name
        elif name in want:
            assert axes == want[name], name
        else:
            assert not any(axes), name
    assert sharded <= set(got)


def test_divisibility_downgrade_and_warning_match_jax():
    """A qkv of 6 outputs over model=4 goes replicated, with one warning
    naming it, on both sides."""
    jm = jax_mesh.make_mesh("data=2,model=4")
    jparams = {"b": {"attn": {"qkv": {"kernel": jnp.zeros((64, 6))},
                              "proj": {"kernel": jnp.zeros((8, 64))}}}}
    with pytest.warns(UserWarning, match="downgraded") as jw:
        jspecs = jax_partition.validate_divisibility(
            jparams, jax_partition.partition_specs(jparams), jm)
    shapes = {"b.attn.qkv.weight": (6, 64), "b.attn.proj.weight": (64, 8)}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = partition.validate_divisibility(
            shapes, partition.partition_specs(shapes),
            {"data": 2, "model": 4})
    assert jspecs["b"]["attn"]["qkv"]["kernel"] == P()
    assert jspecs["b"]["attn"]["proj"]["kernel"] == P("model", None)
    assert got == {"b.attn.qkv.weight": (), "b.attn.proj.weight":
                   (None, "model")}
    assert len(caught) == len(jw) == 1
    assert "1 parameter(s)" in str(caught[0].message)
    assert "b.attn.qkv.weight: dim 0 of (6, 64) not divisible by model=4" \
        in str(caught[0].message)


@pytest.mark.parametrize("min_size", [2 ** 16, 1024, 64])
@pytest.mark.parametrize("axis_size", [1, 2, 4])
def test_fsdp_threshold_matches_jax(min_size, axis_size):
    """``add_fsdp_axis``: which tensors of vit_tiny_test shard over data
    and on which dim, at the default threshold and lower ones; over one
    rank none, and ``fsdp_dims`` (what FSDP2 wraps) picks the same
    tensors."""
    zm = JaxZoo.get_model("vit_tiny_test", classifier=[10], image_size=32,
                          dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: zm.init(jax.random.PRNGKey(0),
                                            image_size=32))["params"]
    jm = jax_mesh.make_mesh(f"data={axis_size}",
                            devices=jax.devices()[:axis_size])
    empty = jax.tree.map(lambda _: P(), shapes)
    jspecs = jax_partition.add_fsdp_axis(shapes, empty, jm,
                                         min_size=min_size)
    leaves = dict((jax.tree_util.keystr(p), s) for p, s in
                  jax.tree_util.tree_flatten_with_path(shapes)[0])
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, P))[0]:
        name = ".".join(str(k.key) for k in path)
        key, axes = _flax_to_port(
            name, spec, len(leaves[jax.tree_util.keystr(path)].shape))
        want[key] = axes
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    port = VisionModelZoo.get_model("vit_tiny_test", classifier=[10],
                                    image_size=32, device="meta")
    port_shapes = {n: tuple(p.shape)
                   for n, p in port.model.named_parameters()}
    got = partition.add_fsdp_axis(
        port_shapes, {n: () for n in port_shapes}, axis_size,
        min_size=min_size)
    patch = "backbone.patch_embed.proj.weight"
    # the patch embedding is a (D, C, p, p) conv weight here and a
    # (p p C, D) kernel there: both shard it or neither, on its own
    # largest dim
    assert ("data" in got[patch]) == any(want.pop(patch))
    for name, spec in got.items():
        axes = tuple(spec) + (None,) * (len(port_shapes[name]) - len(spec))
        if name == patch:
            continue
        if name in want:
            assert axes == want[name], name
        else:
            assert not any(axes), name
    n_sharded = sum(1 for n, s in got.items() if "data" in s
                    and n != patch)
    assert n_sharded == sum(1 for a in want.values() if "data" in a)
    assert (n_sharded == 0) == (min_size == 2 ** 16 or axis_size == 1)
    dims = partition.fsdp_dims(port.model, axis_size, min_size)
    assert set(dims) == {n for n, s in got.items() if "data" in s}


@pytest.mark.parametrize("local,cards,want", [
    (None, 1, "nccl"), ("1", 1, "nccl"), ("2", 1, "gloo"),
    ("4", 4, "nccl"), ("8", 4, "gloo")])
def test_cuda_backend_is_gloo_only_where_local_ranks_share_cards(
        local, cards, want, monkeypatch):
    """NCCL on CUDA unless torchrun's local ranks outnumber the cards
    (NCCL refuses two ranks on one card); gloo on the CPU."""
    import torch

    from vit_torch_tpu_torch.parallel.multihost import dist_backend
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    if local is not None:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert dist_backend(torch.device("cuda", 0)) == want
    assert dist_backend(torch.device("cpu")) == "gloo"


@pytest.mark.parametrize("cutout,auto", [(0, None), (4, "imagenet"),
                                         (6, "cifar10")])
def test_augment_drawn_for_the_global_batch_shards_exactly(cutout, auto):
    """``make_train_augment`` draws what the random wrappers chained draw
    from one seed, and its draws for a global batch of 8, split in four
    with the pictures, give each shard's rows of the whole-batch result
    (what a data mesh's ranks compute)."""
    import torch

    from vit_torch_tpu_torch.data import augment as aug
    from vit_torch_tpu_torch.data.autoaugment import make_autoaugment
    mean, std = (0.4, 0.5, 0.6), (0.2, 0.25, 0.3)
    images = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (8, 24, 24, 3), dtype=np.uint8))
    fn = aug.make_train_augment(mean, std, cutout_size=cutout,
                                auto_policy=auto)
    whole = fn(torch.Generator().manual_seed(3), images)

    gen = torch.Generator().manual_seed(3)
    x = aug.random_hflip(gen, aug.random_crop(gen, images, 2, fill=128))
    if auto:
        x = make_autoaugment(auto)(gen, x)
    x = aug.normalize(x, mean, std)
    if cutout:
        x = aug.cutout(gen, x, cutout)
    assert torch.equal(whole, x)

    draws = fn.draw(torch.Generator().manual_seed(3), 8, (24, 24), "cpu")
    parts = [fn.apply(images[2 * i:2 * i + 2], jax.tree.map(
        lambda t: t[2 * i:2 * i + 2], draws)) for i in range(4)]
    assert torch.equal(torch.cat(parts), whole)



def test_pipeline_state_forms_round_trip_and_match_jax_stacking():
    """``stack_params`` / ``split_vit_params`` / ``state_to_pipe`` and their
    inverses: the stacked blocks equal the JAX ``stack_params`` of the
    same arrays, and every form returns the standard state dict bitwise;
    a stage's renamer maps its local block names to the standard ones."""
    import torch

    from vit_torch_tpu.parallel import pipeline as jax_pipeline
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    from vit_torch_tpu_torch.parallel import pipeline
    zm = VisionModelZoo.get_model("vit_tiny_test", classifier=[10],
                                  image_size=32, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    sd = zm.model.state_dict()
    piped = pipeline.state_to_pipe(sd)
    stacked = {k[len("backbone.pipe_blocks."):]: v for k, v in piped.items()
               if k.startswith("backbone.pipe_blocks.")}
    assert stacked["attn.qkv.weight"].shape == (2, 192, 64)
    blocks = [{k: sd[f"backbone.blocks.{i}.{k}"].numpy() for k in stacked}
              for i in range(2)]
    want = jax_pipeline.stack_params(blocks)
    for k, v in stacked.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
    back = pipeline.state_from_pipe(piped)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    rest, blocks_t = pipeline.split_vit_params(sd, 2, "backbone.")
    merged = pipeline.merge_vit_params(rest, blocks_t, "backbone.")
    assert all(torch.equal(merged[k], sd[k]) for k in sd)
    assert [set(b) for b in pipeline.unstack_params(blocks_t)] == [
        set(stacked)] * 2
    to_pipe, from_pipe = pipeline._renamer(lo=1, per=1)
    assert to_pipe("backbone.blocks.1.mlp.fc1.weight") == \
        "backbone.blocks.0.mlp.fc1.weight"
    assert to_pipe("backbone.blocks.0.norm1.weight") is None
    assert from_pipe("backbone.blocks.0.norm1.weight") == \
        "backbone.blocks.1.norm1.weight"
    assert from_pipe("head.fc0.weight") == "head.fc0.weight"


@pytest.mark.parametrize("arch", ["vit_tiny_test", "swin_test"])
def test_pipeline_refusals_are_the_jax_ones(arch):
    """A non-ViT backbone and nonzero drop rates are refused with the JAX
    messages: a non-ViT backbone, nonzero drop rates, a depth the stages
    do not divide, a per-shard batch the microbatches do not divide."""
    import torch

    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    from vit_torch_tpu_torch.parallel import pipeline
    zm = VisionModelZoo.get_model(arch, classifier=[10], image_size=32,
                                  device="meta")
    if arch == "swin_test":
        with pytest.raises(ValueError, match="supports plain ViT backbones"):
            pipeline._check_pipeline_vit(zm.model.backbone, 2, arch)
        return
    import dataclasses
    bb = zm.model.backbone
    bb.config = dataclasses.replace(bb.config, drop_path_rate=0.1)
    with pytest.raises(ValueError, match="runs blocks deterministically"):
        pipeline._check_pipeline_vit(bb, 2, arch)
    bb.config = dataclasses.replace(bb.config, drop_path_rate=0.0)
    with pytest.raises(ValueError, match="not divisible into 3 pipeline"):
        pipeline._check_pipeline_vit(bb, 3, arch)
    stage = pipeline.PipeStage(None, 0, 2, 4, 2)
    with pytest.raises(ValueError, match="per-shard batch 6 not divisible "
                                         "into 4 microbatches"):
        pipeline.pipeline_apply(lambda h: h, torch.zeros(6, 5, 8), stage)
