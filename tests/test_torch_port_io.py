"""The port's host IO against the JAX package, on the CPU: the PNG codec and
bicubic resize against PIL, experiment folders (`utils/exp_io.py`), the
native prefetcher, the CLIP BPE tokenizer, the safetensors reader and
checkpoint loading (`models/weights.py`).

Checkpoints and tokenizer files are written here from seeded random
weights and a toy vocabulary: no published file is needed.
"""

import dataclasses
import functools
import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from geodiffuser_tpu.config import ModelConfig as JModelConfig
from geodiffuser_tpu.models import tokenizer as jtok
from geodiffuser_tpu.models import weights as jweights
from geodiffuser_tpu.models.clip_text import CLIPTextEncoder as JCLIPTextEncoder
from geodiffuser_tpu.models.unet import UNet2DCondition as JUNet
from geodiffuser_tpu.models.vae import AutoencoderKL as JVAE
from geodiffuser_tpu.utils import exp_io as jexp_io
from geodiffuser_tpu_torch.config import ModelConfig
from geodiffuser_tpu_torch.core.pipeline import Pipeline
from geodiffuser_tpu_torch.models import tokenizer as tok
from geodiffuser_tpu_torch.models import weights
from geodiffuser_tpu_torch.models.clip_text import CLIPTextEncoder
from geodiffuser_tpu_torch.models.unet import UNet2DCondition
from geodiffuser_tpu_torch.models.vae import AutoencoderKL
from geodiffuser_tpu_torch.native import loader
from geodiffuser_tpu_torch.utils import exp_io, png

torch.set_num_threads(1)

# Pillow's resize rounds fixed-point sums; the port follows its arithmetic,
# and is held to one uint8 level
RESIZE_LEVELS = 1


def _image(rng, shape):
    """Random pixels over a smooth ramp, so that PIL's adaptive row filters
    pick every filter type."""
    ramp = np.linspace(0, 255, shape[1])[None, :]
    ramp = ramp.reshape(ramp.shape + (1,) * (len(shape) - 2))
    noise = rng.randint(0, 40, shape)
    img = np.where(rng.rand(*shape) < 0.5, ramp + noise, rng.randint(0, 256, shape))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(23, 37), (23, 37, 3), (23, 37, 4), (23, 37, 2)],
                         ids=["gray", "rgb", "rgba", "gray_alpha"])
def test_png_reads_pil_files(tmp_path, shape):
    img = _image(np.random.RandomState(len(shape)), shape)
    path = str(tmp_path / "a.png")
    Image.fromarray(img).save(path)
    got = png.read_png(path)
    want = np.asarray(Image.open(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.to_rgb(got), np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("shape", [(23, 37), (23, 37, 3)], ids=["gray", "rgb"])
def test_png_written_reads_in_pil(tmp_path, shape):
    img = _image(np.random.RandomState(7), shape)
    path = str(tmp_path / "b.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    with pytest.raises(ValueError, match="write_png"):
        png.write_png(path, np.zeros((4, 4, 4), np.uint8))


def test_png_refuses_what_it_does_not_decode(tmp_path):
    """Palette and 16-bit files raise (PIL reads a palette image as its
    indices, which no experiment folder holds)."""
    for name, img in (("p", Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P")),
                      ("i16", Image.fromarray(np.zeros((4, 4), np.uint16)))):
        path = str(tmp_path / f"{name}.png")
        img.save(path)
        with pytest.raises(ValueError, match="8-bit"):
            png.read_png(path)


def _jax_folder(root, name, rng, size=(24, 32), **extra):
    folder = os.path.join(root, name)
    h, w = size
    jexp_io.save_exp(folder, _image(rng, (h, w, 3)), rng.rand(h, w).astype(np.float32),
                     (rng.rand(h, w) > 0.5).astype(np.float32),
                     np.eye(4) + rng.rand(4, 4) * 0.1, **extra)
    return folder


def _assert_same_experiment(a, b):
    for field in dataclasses.fields(b):
        x, y = getattr(a, field.name), getattr(b, field.name)
        if isinstance(y, np.ndarray):
            assert isinstance(x, np.ndarray), field.name
            assert x.dtype == y.dtype and x.shape == y.shape, field.name
            np.testing.assert_array_equal(x, y, err_msg=field.name)
        else:
            assert x == y, field.name


@pytest.fixture(scope="module")
def jax_folders(tmp_path_factory):
    """Folders written by the JAX package's save_exp: plain, with every
    optional image, float64 depth and another image shape."""
    root = str(tmp_path_factory.mktemp("jax_exps"))
    rng = np.random.RandomState(0)
    imgs = {k: _image(rng, (24, 32, 3)) for k in ("background_image", "transformed_image",
                                                  "result")}
    folders = [_jax_folder(root, "0", rng), _jax_folder(root, "1", rng, **imgs),
               _jax_folder(root, "2", rng, image_shape=(480, 640))]
    f3 = _jax_folder(root, "3", rng)
    np.save(os.path.join(f3, "depth.npy"), rng.rand(24, 32))
    os.remove(os.path.join(f3, "image_shape.npy"))
    return folders + [f3]


def test_read_exp_matches_jax(jax_folders):
    for folder in jax_folders:
        _assert_same_experiment(exp_io.read_exp(folder), jexp_io.read_exp(folder))


def test_save_exp_matches_jax(tmp_path):
    """A folder the port writes reads the same in both packages, and its
    files hold the same pixels and arrays as the JAX package's."""
    rng = np.random.RandomState(3)
    args = (_image(rng, (24, 32, 3)), rng.rand(24, 32).astype(np.float32),
            rng.rand(24, 32).astype(np.float32), np.eye(4))
    kw = dict(background_image=_image(rng, (24, 32, 3)), image_shape=(30, 40))
    exp_io.save_exp(str(tmp_path / "t"), *args, **kw)
    jexp_io.save_exp(str(tmp_path / "j"), *args, **kw)
    _assert_same_experiment(exp_io.read_exp(str(tmp_path / "t")),
                            dataclasses.replace(jexp_io.read_exp(str(tmp_path / "j")),
                                                path=str(tmp_path / "t")))
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for name in os.listdir(tmp_path / "t"):
        a, b = str(tmp_path / "t" / name), str(tmp_path / "j" / name)
        load = np.load if name.endswith(".npy") else (lambda p: np.asarray(Image.open(p)))
        np.testing.assert_array_equal(load(a), load(b), err_msg=name)


def test_listing_and_routing_match_jax(tmp_path):
    """Every category, a stitch folder, numbers past 9, a folder without an
    input image and stray files."""
    rng = np.random.RandomState(1)
    root = str(tmp_path)
    for cat in jexp_io.CATEGORIES + ("stitch", "Stitching"):
        for num in ("0", "10", "2"):
            _jax_folder(root, os.path.join(cat, num), rng, size=(8, 8))
    os.makedirs(os.path.join(root, "Mix", "11"))                  # no input image
    os.makedirs(os.path.join(root, "notes"))                      # empty category
    open(os.path.join(root, "README.txt"), "w").close()           # a file at the root
    open(os.path.join(root, "Removal", "log.txt"), "w").close()   # a file in a category
    assert list(exp_io.list_experiments(root)) == list(jexp_io.list_experiments(root))
    assert exp_io.CATEGORIES == jexp_io.CATEGORIES
    for cat in jexp_io.CATEGORIES + ("stitch", "Stitching", "geometry_stitch", "other"):
        assert exp_io.edit_type_for_category(cat) == jexp_io.edit_type_for_category(cat), cat


def test_save_results_matches_jax(tmp_path):
    """loss_log.json equal, result_ls.png equal pixels, the resized result
    within RESIZE_LEVELS of PIL's bicubic (upsampled in x, reduced in y)."""
    rng = np.random.RandomState(2)
    edited = _image(rng, (64, 64, 3))
    loss_log = {0: {"total": 1.5, "self/sim": 0.25}, 2: {"total": 0.75, "self/sim": 0.125}}
    for pkg, name in ((exp_io, "t"), (jexp_io, "j")):
        folder = tmp_path / name
        folder.mkdir()
        exp = pkg.Experiment(edited, np.zeros((64, 64), np.float32), np.zeros((64, 64)),
                             np.eye(4), np.array([48, 80]), path=str(folder))
        pkg.save_results(exp, edited, loss_log)
    t, j = tmp_path / "t", tmp_path / "j"
    assert (t / "loss_log.json").read_text() == (j / "loss_log.json").read_text()
    np.testing.assert_array_equal(png.read_png(str(t / "result_ls.png")),
                                  np.asarray(Image.open(j / "result_ls.png")))
    got = png.read_png(str(t / "resized_result_ls.png")).astype(int)
    want = np.asarray(Image.open(j / "resized_result_ls.png")).astype(int)
    assert got.shape == want.shape == (48, 80, 3)
    assert np.abs(got - want).max() <= RESIZE_LEVELS


@pytest.mark.parametrize("hw", [(48, 80), (100, 30), (64, 64), (17, 129)])
def test_resize_bicubic_matches_pil(hw):
    img = _image(np.random.RandomState(4), (64, 64, 3))
    want = np.asarray(Image.fromarray(img).resize(hw[::-1])).astype(int)
    assert np.abs(png.resize_bicubic(img, *hw).astype(int) - want).max() <= RESIZE_LEVELS


def test_native_prefetcher_matches_read_exp(jax_folders, tmp_path):
    """The native library builds with g++ and yields, in order, the same
    Experiments as the port's read_exp; a folder it cannot decode (a
    big-endian depth.npy) goes through read_exp."""
    rng = np.random.RandomState(5)
    odd = _jax_folder(str(tmp_path), "odd", rng)
    np.save(os.path.join(odd, "depth.npy"), rng.rand(24, 32).astype(">f4"))
    folders = list(jax_folders) + [odd]
    got = list(loader.NativePrefetcher(folders, threads=2))
    assert [e.path for e in got] == folders
    assert got[-1].depth.dtype == np.dtype(">f4")
    for e in got:
        _assert_same_experiment(e, exp_io.read_exp(e.path))
    # folder order whatever order the threads finish in, with a short queue
    many = folders * 4
    for threads, queue in ((16, 1), (3, 2)):
        assert [e.path for e in loader.NativePrefetcher(many, threads, queue)] == many
    assert os.path.exists(loader.library_path())
    f0 = jax_folders[0]
    np.testing.assert_array_equal(loader.load_png(os.path.join(f0, "input_image.png")),
                                  exp_io.read_exp(f0).input_image)
    np.testing.assert_array_equal(loader.load_npy(os.path.join(f0, "depth.npy")),
                                  np.load(os.path.join(f0, "depth.npy")).astype(np.float64))


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

TOY_WORDS = ("a", "photo", "of", "the", "cat", "dog", "on", "mat", "sitting", "red", "big",
             "house", "café", "tree", ",", ".", "!", "'s")


def write_toy_tokenizer(checkpoint_dir: str) -> None:
    """A small byte-level BPE vocabulary in the HF layout: every byte
    symbol, with and without `</w>`, merges that build the toy words, and
    the two special tokens."""
    byte_chars = list(tok._bytes_to_unicode().values())
    vocab = byte_chars + [c + "</w>" for c in byte_chars]
    merges = []
    for word in TOY_WORDS:
        syms = [tok._bytes_to_unicode()[b] for b in word.encode("utf-8")]
        syms[-1] += "</w>"
        while len(syms) > 1:
            merges.append(f"{syms[0]} {syms[1]}")
            syms = [syms[0] + syms[1]] + syms[2:]
            vocab.append(syms[0])
    vocab = list(dict.fromkeys(vocab)) + ["<|startoftext|>", "<|endoftext|>"]
    merges = list(dict.fromkeys(merges))
    tok_dir = os.path.join(checkpoint_dir, "tokenizer")
    os.makedirs(tok_dir, exist_ok=True)
    with open(os.path.join(tok_dir, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    with open(os.path.join(tok_dir, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")


PROMPTS = [
    "",
    "A photo of the cat",
    "a  big   red\thouse,\n on the mat!",
    "the dog's café — naïve 猫 🐱",
    "photo photography photon",
    " ".join(["sitting dog on a mat"] * 20),       # past 77 tokens
]


def test_clip_tokenizer_matches_jax(tmp_path):
    write_toy_tokenizer(str(tmp_path))
    mine = tok.load_tokenizer(str(tmp_path), 1000, 77)
    ref = jtok.load_tokenizer(str(tmp_path), 1000, 77)
    assert isinstance(mine, tok.CLIPTokenizer) and isinstance(ref, jtok.CLIPTokenizer)
    got, want = mine(PROMPTS), ref(PROMPTS)
    assert got.dtype == want.dtype and got.shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(got, want)
    assert (got[-1] != mine.eos).sum() == 76          # truncated: bos + 75 ids + eos
    assert isinstance(tok.load_tokenizer(str(tmp_path / "none"), 1000), tok.HashTokenizer)
    assert isinstance(tok.load_tokenizer(None), tok.HashTokenizer)


# ---------------------------------------------------------------------------
# safetensors and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_safetensors_reader_equal_bits(tmp_path, dtype):
    """F32 and F16 written by safetensors.numpy.save_file; BF16, which
    numpy lacks, by safetensors.torch.save_file."""
    rng = np.random.RandomState(6)
    arrays = {"w": rng.randn(3, 5, 2), "b": rng.randn(7), "s": rng.randn(1, 1)}
    path = str(tmp_path / "x.safetensors")
    if dtype == "BF16":
        from safetensors.torch import save_file

        want = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in arrays.items()}
        save_file(want, path)
    else:
        from safetensors.numpy import save_file

        np_dt = {"F32": np.float32, "F16": np.float16}[dtype]
        save_file({k: v.astype(np_dt) for k, v in arrays.items()}, path)
        want = {k: torch.from_numpy(v.astype(np_dt)) for k, v in arrays.items()}
    got = weights.read_safetensors(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(got[k].view(torch.int16 if dtype != "F32" else torch.int32),
                           want[k].view(torch.int16 if dtype != "F32" else torch.int32))


def test_safetensors_reader_rejects_unknown_dtype(tmp_path):
    from safetensors.numpy import save_file

    path = str(tmp_path / "c.safetensors")
    save_file({"z": np.zeros(3, np.complex64)}, path)
    with pytest.raises(ValueError, match="C64"):
        weights.read_safetensors(path)
    header = json.dumps({"q": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}})
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header.encode() + b"\0\0")
    with pytest.raises(ValueError, match="F8_E4M3"):
        weights.read_safetensors(path)


def _module_states(config):
    with torch.device("meta"):
        return {"unet": UNet2DCondition(config).state_dict(),
                "vae": AutoencoderKL(config).state_dict(),
                "text": CLIPTextEncoder(config).state_dict()}


def write_checkpoint(checkpoint_dir: str, seed: int = 0, dtype=np.float32) -> dict:
    """A seeded random diffusers-layout checkpoint of ModelConfig.tiny() as
    safetensors (with the text encoder's int64 position_ids, which nothing
    consumes).  Returns the state_dicts written."""
    from safetensors.numpy import save_file

    rng = np.random.RandomState(seed)
    states = {}
    for name, state in _module_states(ModelConfig.tiny()).items():
        states[name] = {k: (rng.randn(*v.shape) * 0.1).astype(dtype) for k, v in state.items()}
    written = dict(states, text=dict(
        states["text"], **{"text_model.embeddings.position_ids": np.arange(77)[None]}))
    for name, (rel, _) in weights.COMPONENTS.items():
        path = os.path.join(checkpoint_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_file(written[name], path)
    return states


@functools.lru_cache(maxsize=None)
def _jax_init_params(config):
    """The JAX package's init params as shapes only (jax.eval_shape, no
    compile), as tests/test_checkpoint_manifests.py builds them; traced once
    a process for both test files."""
    key = jax.random.PRNGKey(0)
    return {
        "unet": jax.eval_shape(lambda k: JUNet(config).init(
            k, jnp.zeros((1, 8, 8, 4)), jnp.int32(1),
            jnp.zeros((1, 77, config.cross_attention_dim))), key),
        "vae": jax.eval_shape(lambda k: JVAE(config).init(k, jnp.zeros((1, 32, 32, 3))), key),
        "text": jax.eval_shape(lambda k: JCLIPTextEncoder(config).init(
            k, jnp.zeros((1, 77), jnp.int32)), key),
    }


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    states = write_checkpoint(ckpt)
    jcfg = JModelConfig.tiny()
    jparams = jweights.load_sd_checkpoint(ckpt, _jax_init_params(jcfg), jcfg)
    ref = weights.from_jax_params(jax.tree.map(np.asarray, jparams), ModelConfig.tiny())
    return ckpt, states, ref


def _loaded(pipe):
    return {name: {k: v.clone() for k, v in m.state_dict().items()}
            for name, m in pipe.modules().items()}


def test_checkpoint_matches_jax_loader(tiny_checkpoint, tmp_path):
    """The port's load_sd_checkpoint equals the JAX package's (carried over
    by from_jax_params), exactly in float32; the .bin fallback loads the
    same."""
    ckpt, states, ref = tiny_checkpoint
    pipe = Pipeline.create(ModelConfig.tiny(), image_size=64, device="cpu")
    read = weights.load_sd_checkpoint(ckpt, pipe)
    assert "text_model.embeddings.position_ids" not in read["text"]
    got = _loaded(pipe)
    for name in ref:
        assert set(got[name]) == set(ref[name]) == set(states[name]), name
        for k in ref[name]:
            assert got[name][k].dtype == torch.float32
            assert torch.equal(got[name][k], ref[name][k]), (name, k)
            assert torch.equal(got[name][k], torch.from_numpy(states[name][k])), (name, k)
    for name, (rel, _) in weights.COMPONENTS.items():
        os.makedirs(os.path.dirname(tmp_path / rel), exist_ok=True)
        sd = weights.read_safetensors(os.path.join(ckpt, rel))
        torch.save(sd, str(tmp_path / rel).replace(".safetensors", ".bin"))
    pipe_bin = Pipeline.create(ModelConfig.tiny(), image_size=64, seed=1, device="cpu")
    weights.load_sd_checkpoint(str(tmp_path), pipe_bin)
    got_bin = _loaded(pipe_bin)
    for name in ref:
        for k in ref[name]:
            assert torch.equal(got_bin[name][k], ref[name][k]), (name, k)


def test_checkpoint_refuses_missing_and_misshaped_keys(tiny_checkpoint, tmp_path):
    from safetensors.numpy import save_file

    ckpt, states, _ = tiny_checkpoint
    rel = weights.COMPONENTS["vae"][0]
    for case in ("missing", "misshaped", "extra"):
        bad = str(tmp_path / case)
        for name, (r, _) in weights.COMPONENTS.items():
            os.makedirs(os.path.dirname(os.path.join(bad, r)), exist_ok=True)
            if r != rel:
                os.link(os.path.join(ckpt, r), os.path.join(bad, r))
        vae = dict(states["vae"])
        key = "decoder.conv_out.weight"
        if case == "missing":
            del vae[key]
            want = f"missing=['{key}']"
        elif case == "misshaped":
            vae[key] = np.ascontiguousarray(vae[key][:, :, :2])
            want = f"shape-mismatch=[('{key}', (3, 16, 3, 3), (3, 16, 2, 3))]"
        else:
            vae["decoder.conv_out.lora"] = vae[key]
            want = "extra=['decoder.conv_out.lora']"
        save_file(vae, os.path.join(bad, rel))
        pipe = Pipeline.create(ModelConfig.tiny(), image_size=64, device="cpu")
        before = _loaded(pipe)
        with pytest.raises(ValueError, match="vae checkpoint mismatch") as err:
            weights.load_sd_checkpoint(bad, pipe)
        assert want in str(err.value), str(err.value)
        after = _loaded(pipe)      # nothing was loaded
        assert all(torch.equal(after[n][k], before[n][k]) for n in before for k in before[n])


def test_vae_override(tiny_checkpoint, tmp_path):
    ckpt, states, _ = tiny_checkpoint
    pipe = Pipeline.create(ModelConfig.tiny(), image_size=64, device="cpu")
    os.makedirs(tmp_path / "vae")
    os.link(os.path.join(ckpt, weights.COMPONENTS["vae"][0]),
            tmp_path / "vae" / "diffusion_pytorch_model.safetensors")
    weights.load_vae_override(str(tmp_path), pipe)
    for k, v in pipe.vae.state_dict().items():
        assert torch.equal(v, torch.from_numpy(states["vae"][k])), k
    with pytest.raises(FileNotFoundError):
        weights.load_vae_override(str(tmp_path / "none"), pipe)


def test_full_geometry_matches_the_manifests():
    """The port's SD-1.4 modules (ModelConfig(), built on the meta device)
    have exactly the published checkpoints' keys and shapes, less the
    manifests' `unconsumed` keys: a real SD-1.4 file loads strictly."""
    for name, state in _module_states(ModelConfig()).items():
        manifest = weights.MANIFESTS / weights.COMPONENTS[name][1]
        with open(manifest) as f:
            m = json.load(f)
        want = {k: tuple(s) for k, s in m["keys"].items() if k not in m["unconsumed"]}
        assert {k: tuple(v.shape) for k, v in state.items()} == want, name
        assert sum(int(np.prod(s)) for s in m["keys"].values()) == m["param_count"]
