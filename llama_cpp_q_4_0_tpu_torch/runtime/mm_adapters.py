"""Named multimodal front-ends over the embd-input surface.

The reference ships three example adapters that map specific checkpoint
projector weights onto its embd-input API:

- LLaVA      (examples/embd-input/llava.py:11-52): CLIP ViT-L/14 patch
  features (hidden layer -2, CLS dropped) -> ``model.mm_projector``
  nn.Linear -> ``<im_start> [patches] <im_patch>*pad <im_end>`` prompt
  protocol.
- MiniGPT-4  (examples/embd-input/minigpt4.py): EVA-CLIP + Q-Former query
  output -> ``llama_proj`` nn.Linear -> ``Human: <Img>...</Img>`` chat with
  a fixed system prompt and ``###`` turn separator.
- PandaGPT   (examples/embd-input/panda_gpt.py): ImageBind embeddings for
  image/audio/video/thermal -> ``llama_proj`` nn.Linear -> the same
  ``###``-separated Vicuna chat protocol (usually over a LoRA'd base).

Each adapter takes its vision encoder (CLIP, EVA, ImageBind) as a callable
from the caller and owns everything downstream of it: projector weight
loading from the real checkpoint key layout, the prompt and token protocol,
and stop-string generation; the port's copy of the JAX package's
``runtime/mm_adapters.py``.  Convention divergence from the
reference, by design: feature/embedding arrays here are ``[T, dim]``
(the reference's C ABI wants ``[n_embd, T]``, hence the ``.T`` calls in
its adapter scripts — see embd_input.py:27 passing ``x.shape[1]``).
"""

from __future__ import annotations

import numpy as np
import torch

from .embd_input import EmbdInput, LinearProjector


def _to_numpy(x) -> np.ndarray:
    """Accept torch tensors or arrays from a checkpoint dict."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def load_torch_projector(path: str, weight_key: str, bias_key: str | None = None,
                         *, root_key: str | None = None) -> LinearProjector:
    """Load an nn.Linear projector out of a torch checkpoint file.

    Mirrors the reference adapters' ``load_projection`` methods: llava.py:24
    reads flat ``model.mm_projector.{weight,bias}``; minigpt4.py:103 reads
    ``state["model"]["llama_proj.{weight,bias}"]`` (root_key="model");
    panda_gpt.py:29 reads flat ``llama_proj.{weight,bias}``.
    """
    state = torch.load(path, map_location="cpu", weights_only=True)
    if root_key is not None:
        state = state[root_key]
    weight = _to_numpy(state[weight_key])
    bias = _to_numpy(state[bias_key]) if bias_key is not None and bias_key in state else None
    return LinearProjector(weight, bias)


class Llava:
    """LLaVA front-end (examples/embd-input/llava.py:17-52).

    ``vision_encoder(image) -> [n_patches, vis_dim]`` must already apply the
    LLaVA feature recipe — CLIP hidden_states[-2] with the CLS token dropped
    (llava.py:14,41-42); this class owns the projector and prompt protocol.
    Token ids default to the LLaVA-13b-v1.1 vocab layout (llava.py:46-49:
    im_patch=32000, im_start=32001, im_end=32002, image_token_len=256).
    """

    def __init__(self, model: EmbdInput, vision_encoder=None,
                 projector: LinearProjector | None = None, *,
                 image_token_len: int = 256, im_patch: int = 32000,
                 im_start: int = 32001, im_end: int = 32002):
        self.model = model
        self.vision_encoder = vision_encoder
        self.projector = projector
        self.image_token_len = image_token_len
        self.im_patch, self.im_start, self.im_end = im_patch, im_start, im_end

    def load_projection(self, path: str) -> None:
        """llava.py:24-28 — keys ``model.mm_projector.{weight,bias}``."""
        self.projector = load_torch_projector(
            path, "model.mm_projector.weight", "model.mm_projector.bias")

    def embed_image(self, image) -> np.ndarray:
        feats = _to_numpy(self.vision_encoder(image))
        if self.projector is None:
            raise RuntimeError("load_projection() first")
        return self.projector(feats)

    def chat(self, question: str, n_predict: int = 256) -> str:
        self.model.eval_text("user: ")
        self.model.eval_text(question)
        self.model.eval_text("\nassistant: ")
        return self.model.generate_text(n_predict)

    def chat_with_image(self, image, question: str, n_predict: int = 256) -> str:
        """llava.py:37-52: user turn = <im_start> patches <im_patch>-pad
        <im_end>, then the question."""
        embd = self.embed_image(image)
        self.model.eval_text("user: ")
        self.model.eval_token(self.im_start)
        self.model.eval_float(embd)
        for _ in range(self.image_token_len - embd.shape[0]):
            self.model.eval_token(self.im_patch)
        self.model.eval_token(self.im_end)
        self.model.eval_text(question)
        self.model.eval_text("\nassistant: ")
        return self.model.generate_text(n_predict)


_MINIGPT4_SYSTEM = (
    "Give the following image: <Img>ImageContent</Img>. "
    "You will be able to see the image once I provide it to you. "
    "Please answer my questions."
    "###"
)


class MiniGPT4:
    """MiniGPT-4 front-end (examples/embd-input/minigpt4.py).

    ``qformer_encoder(image) -> [n_query, qformer_hidden]`` stands in for
    the EVA-ViT + Q-Former stack (minigpt4.py:76-97 encode_img up to
    ``llama_proj``); the fixed system prompt (minigpt4.py:70-73), the
    ``Human: <Img>...</Img>`` protocol and the ``###`` stop string live
    here.
    """

    def __init__(self, model: EmbdInput, qformer_encoder=None,
                 projector: LinearProjector | None = None):
        self.model = model
        self.qformer_encoder = qformer_encoder
        self.projector = projector
        self.model.eval_text(_MINIGPT4_SYSTEM)

    def load_projection(self, path: str) -> None:
        """minigpt4.py:101-105 — ``state["model"]["llama_proj.{weight,bias}"]``."""
        self.projector = load_torch_projector(
            path, "llama_proj.weight", "llama_proj.bias", root_key="model")

    def encode_img(self, image) -> np.ndarray:
        feats = _to_numpy(self.qformer_encoder(image))
        if self.projector is None:
            raise RuntimeError("load_projection() first")
        return self.projector(feats)

    def chat(self, question: str, n_predict: int = 256) -> str:
        self.model.eval_text("Human: ")
        self.model.eval_text(question)
        self.model.eval_text("\n### Assistant:")
        return self.model.generate_text(n_predict, end="###")

    def chat_with_image(self, image, question: str, n_predict: int = 256) -> str:
        embd = self.encode_img(image)
        self.model.eval_text("Human: <Img>")
        self.model.eval_float(embd)
        self.model.eval_text("</Img> ")
        self.model.eval_text(question)
        self.model.eval_text("\n### Assistant:")
        return self.model.generate_text(n_predict, end="###")


class PandaGPT:
    """PandaGPT front-end (examples/embd-input/panda_gpt.py).

    ``encoders`` maps modality key ("image"/"audio"/"video"/"thermal") to a
    callable ``paths -> [T, 1024]`` standing in for ImageBind
    (panda_gpt.py:60-84); this class owns llama_proj, the multimodal input
    protocol (``<Img>`` wrapping every modality, panda_gpt.py:36-41), and
    the stateful ``###`` Vicuna chat (panda_gpt.py:43-55).  The reference
    runs this over a LoRA'd base model — pass an adapter-merged Context in.
    """

    MODALITIES = ("image", "audio", "video", "thermal")

    def __init__(self, model: EmbdInput, encoders: dict | None = None,
                 projector: LinearProjector | None = None):
        self.model = model
        self.encoders = encoders or {}
        self.projector = projector
        self.generated_text = ""

    def load_projection(self, path: str) -> None:
        """panda_gpt.py:28-32 — flat ``llama_proj.{weight,bias}``."""
        self.projector = load_torch_projector(
            path, "llama_proj.weight", "llama_proj.bias")

    def extract_multimodal_feature(self, inputs: dict) -> list[np.ndarray]:
        """panda_gpt.py:57-63: one projected embedding span per modality
        present in ``inputs`` (keys ``<modality>_paths``), in a fixed order."""
        if self.projector is None:
            raise RuntimeError("load_projection() first")
        feats = []
        for key in self.MODALITIES:
            if key + "_paths" in inputs:
                raw = _to_numpy(self.encoders[key](inputs[key + "_paths"]))
                feats.append(self.projector(raw))
        return feats

    def eval_inputs(self, inputs: dict) -> None:
        self.model.eval_text("<Img>")
        for embd in self.extract_multimodal_feature(inputs):
            self.model.eval_float(embd)
        self.model.eval_text("</Img> ")

    def chat(self, question: str, n_predict: int = 256) -> str:
        return self.chat_with_image(None, question, n_predict)

    def chat_with_image(self, inputs: dict | None, question: str,
                        n_predict: int = 256) -> str:
        if self.generated_text == "":
            self.model.eval_text("###")
        self.model.eval_text(" Human: ")
        if inputs:
            self.eval_inputs(inputs)
        self.model.eval_text(question)
        self.model.eval_text("\n### Assistant:")
        ret = self.model.generate_text(n_predict, end="###")
        self.generated_text += ret
        return ret
