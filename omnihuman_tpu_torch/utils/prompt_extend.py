"""LLM prompt extension (port of omnihuman_tpu/utils/prompt_extend.py).

`PromptExpander` with the t2v / i2v system prompts (Chinese and English),
`DashScopePromptExpander` (the remote API: it refuses without a key or
without the `dashscope` package, and nothing here reaches the network
otherwise), `TemplatePromptExpander` (the deterministic offline expander:
the JAX strings and `random.Random(seed)` draws, so it returns JAX's
string for string) and `QwenPromptExpander` (a local Qwen2 / 2.5 through
the port's `models/qwen.py`), each returning a `PromptOutput`.

`QwenPromptExpander` runs on the GPU unless `device="cpu"` is given (JAX's
default device is the CPU of its HF-torch route; ROADMAP C). Its model
comes from `checkpoint_path` (a state-dict file or an HF directory), or
from `model_name` where that names a local HF directory, and the
tokenizer from local files through `transformers.AutoTokenizer`. Without
loadable weights or tokenizer it falls back to the template expander
with JAX's message prefix.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Optional

LM_EN_SYS_PROMPT = (
    "You are a prompt engineer for a text-to-video model. Rewrite the "
    "user's prompt into a detailed, fluent description: add subject "
    "appearance, scene, lighting, camera movement and style; keep the "
    "original meaning; output only the rewritten prompt."
)
LM_ZH_SYS_PROMPT = (
    "你是一个视频生成提示词工程师。请将用户输入改写为细节丰富的画面描述："
    "补充主体外观、场景、光线、镜头运动与风格，保持原意，只输出改写结果。"
)
VL_EN_SYS_PROMPT = (
    "You are a prompt engineer for an image-to-video model. Given the "
    "reference image and the user's prompt, describe the subject, "
    "appearance and intended motion in detail; output only the prompt."
)


@dataclasses.dataclass
class PromptOutput:
    status: bool
    prompt: str
    seed: int
    system_prompt: str
    message: str = ""

    def add_custom_field(self, key: str, value) -> None:
        setattr(self, key, value)


class PromptExpander:
    """Base class: system-prompt choice and the `extend` / call surface."""

    def __init__(self, model_name: Optional[str] = None, is_vl: bool = False,
                 **kwargs):
        self.model_name = model_name
        self.is_vl = is_vl

    def decide_system_prompt(self, tar_lang: str = "en") -> str:
        if self.is_vl:
            return VL_EN_SYS_PROMPT
        return LM_ZH_SYS_PROMPT if tar_lang == "zh" else LM_EN_SYS_PROMPT

    def extend(self, prompt: str, system_prompt: Optional[str] = None,
               seed: int = -1, image=None, tar_lang: str = "en"
               ) -> PromptOutput:
        if seed < 0:
            seed = random.randint(0, 2 ** 31)
        sp = system_prompt or self.decide_system_prompt(tar_lang)
        return self._call(prompt, sp, seed, image)

    def _call(self, prompt, system_prompt, seed, image) -> PromptOutput:
        raise NotImplementedError

    __call__ = extend


class DashScopePromptExpander(PromptExpander):
    """The remote DashScope API: DASH_API_KEY and the `dashscope` package,
    else a failed PromptOutput saying which is missing."""

    def __init__(self, api_key: Optional[str] = None, model_name=None,
                 is_vl=False, retry_times: int = 4, **kwargs):
        super().__init__(model_name or (
            "qwen-vl-max" if is_vl else "qwen-plus"), is_vl)
        self.api_key = api_key or os.environ.get("DASH_API_KEY")
        self.retry_times = retry_times

    def _call(self, prompt, system_prompt, seed, image) -> PromptOutput:
        if not self.api_key:
            return PromptOutput(False, prompt, seed, system_prompt,
                                "DASH_API_KEY not set")
        try:
            import dashscope
        except ImportError:
            return PromptOutput(False, prompt, seed, system_prompt,
                                "dashscope not installed")
        last = "no attempt made"
        for _ in range(self.retry_times):
            try:
                dashscope.api_key = self.api_key
                messages = [
                    {"role": "system", "content": system_prompt},
                    {"role": "user", "content": prompt},
                ]
                resp = dashscope.Generation.call(
                    self.model_name, messages=messages, seed=seed,
                    result_format="message")
                text = resp.output.choices[0].message.content
                return PromptOutput(True, text, seed, system_prompt,
                                    json.dumps(resp, ensure_ascii=False,
                                               default=str))
            except Exception as e:   # a remote service's failure, retried
                last = str(e)
        return PromptOutput(False, prompt, seed, system_prompt, last)


class TemplatePromptExpander(PromptExpander):
    """Deterministic offline expander: the system prompt's checklist
    (lighting / camera / detail) as template clauses drawn by seed."""

    _STYLES = ("cinematic lighting", "soft natural light",
               "golden hour glow", "studio lighting")
    _CAMERA = ("slow dolly-in", "static tripod shot", "gentle pan",
               "handheld tracking shot")
    _DETAIL = ("highly detailed", "sharp focus", "rich textures",
               "8k quality")
    _STYLES_ZH = ("电影感打光", "柔和的自然光", "黄金时刻光晕", "影棚灯光")
    _CAMERA_ZH = ("缓慢推近镜头", "固定三脚架镜头", "缓缓平移", "手持跟拍")
    _DETAIL_ZH = ("细节丰富", "清晰锐利", "质感细腻", "超高清画质")

    def _call(self, prompt, system_prompt, seed, image) -> PromptOutput:
        rng = random.Random(seed)
        zh = system_prompt == LM_ZH_SYS_PROMPT
        styles, camera, detail = (
            (self._STYLES_ZH, self._CAMERA_ZH, self._DETAIL_ZH) if zh
            else (self._STYLES, self._CAMERA, self._DETAIL))
        sep, end = ("，", "。") if zh else (", ", ".")
        extended = (f"{prompt.strip().rstrip('.。')}{end}"
                    f"{rng.choice(styles)}{sep}"
                    f"{rng.choice(camera)}{sep}"
                    f"{rng.choice(detail)}{end}")
        return PromptOutput(True, extended, seed, system_prompt,
                            "template-expanded (offline fallback)")


class QwenPromptExpander(PromptExpander):
    """A local Qwen2 / 2.5 (-VL names) through models/qwen.py: greedy
    decoding of `max_new_tokens` after the chat template, on `device`
    (default: the GPU). Falls back to TemplatePromptExpander when no
    weights or tokenizer load."""

    def __init__(self, model_name: Optional[str] = None, is_vl=False,
                 device=None, checkpoint_path: Optional[str] = None,
                 tokenizer_path: Optional[str] = None,
                 max_new_tokens: int = 512, **kwargs):
        from omnihuman_tpu_torch.pipelines.text2video import resolve_device
        super().__init__(model_name or (
            "Qwen/Qwen2.5-VL-3B-Instruct" if is_vl
            else "Qwen/Qwen2.5-3B-Instruct"), is_vl)
        self.device = resolve_device(device)
        self.checkpoint_path = checkpoint_path
        self.tokenizer_path = tokenizer_path
        self.max_new_tokens = max_new_tokens
        self._tok = None
        self._qwen = None                 # (model, cfg)
        self._fallback = TemplatePromptExpander(is_vl=is_vl)

    def _weights_path(self) -> Optional[str]:
        if self.checkpoint_path and os.path.exists(self.checkpoint_path):
            return self.checkpoint_path
        if self.model_name and os.path.isdir(self.model_name):
            return self.model_name
        return None

    def _load_tokenizer(self) -> bool:
        if self._tok is not None:
            return True
        try:
            from transformers import AutoTokenizer
            self._tok = AutoTokenizer.from_pretrained(
                self.tokenizer_path or self.model_name,
                local_files_only=True)
            return True
        except (ImportError, OSError, ValueError):
            return False

    def _load(self) -> bool:
        """The model through the port's loader (JAX `_load_jax`)."""
        if self._qwen is not None:
            return True
        path = self._weights_path()
        if path is None or not self._load_tokenizer():
            return False
        from omnihuman_tpu_torch.models.qwen import load_qwen_checkpoint
        try:
            self._qwen = load_qwen_checkpoint(path, device=self.device)
        except (OSError, KeyError, ValueError):
            return False
        return True

    def _chat_ids(self, prompt, system_prompt):
        msgs = [{"role": "system", "content": system_prompt},
                {"role": "user", "content": prompt}]
        text = self._tok.apply_chat_template(
            msgs, tokenize=False, add_generation_prompt=True)
        return self._tok([text], return_tensors="np").input_ids

    def _call(self, prompt, system_prompt, seed, image) -> PromptOutput:
        if self._load():
            import torch

            from omnihuman_tpu_torch.models.qwen import qwen_generate
            model, _ = self._qwen
            ids = torch.as_tensor(self._chat_ids(prompt, system_prompt),
                                  dtype=torch.int64, device=self.device)
            # an eos id of 0 is an eos id (JAX reads 0 as missing)
            eos = self._tok.eos_token_id
            eos = -1 if eos is None else int(eos)
            gen = torch.Generator(device=self.device).manual_seed(
                max(seed, 0))
            out = qwen_generate(
                model, ids, torch.tensor([ids.shape[1]], device=self.device),
                max_new_tokens=self.max_new_tokens, generator=gen,
                eos_id=eos)
            toks = [int(t) for t in out[0].tolist() if int(t) != eos]
            reply = self._tok.decode(toks, skip_special_tokens=True)
            return PromptOutput(True, reply, seed, system_prompt,
                                "qwen-torch")
        out = self._fallback._call(prompt, system_prompt, seed, image)
        out.message = ("Qwen weights unavailable; " + out.message)
        return out
