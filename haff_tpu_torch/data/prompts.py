"""Prompt templates and conversation formatting (port of
haff_tpu/data/prompts.py, a copy: the strings decide the tokens).

Capability parity with reference utils/aff_dataset.py:29-46 (question/
answer templates) and llava/conversation.py (llava_v1 template with
SeparatorStyle.TWO). The exact strings matter: tokenization must match the
shipped checkpoints for weight-converted parity."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from ..core.config import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
)

SHORT_QUESTION_LIST = [
    DEFAULT_IMAGE_TOKEN + "\n" + "Can you show me where I have to interact "
    "with the objects to perform the following task: {class_name}?",
    DEFAULT_IMAGE_TOKEN + "\n" + "Please segment the region to perform the "
    "action '{class_name}' in this image.",
    DEFAULT_IMAGE_TOKEN + "\n" + "How can I perform the action "
    "'{class_name}' in this image? Please respond with segmentation mask.",
    DEFAULT_IMAGE_TOKEN + "\n" + "How can I perform the action "
    "'{class_name}' in this image? Please output segmentation mask.",
]

ANSWER_LIST = [
    "It is [SEG].",
    "Sure, [SEG].",
    "Sure, it is [SEG].",
    "Sure, the segmentation result is [SEG].",
    "[SEG].",
]

# The benchmark-inference prompt (reference inference.py:221-226).
INFERENCE_QUESTION = (
    DEFAULT_IMAGE_TOKEN + "\n" + "Where would you interact with the object "
    "to perform action {class_name}")


@dataclass
class Conversation:
    """Two-role conversation.

    style="two": llava_v1 (SeparatorStyle.TWO) layout — system + sep +
    'USER: q' + sep + 'ASSISTANT: a' + sep2.
    style="llama_2": reference conversation.py SeparatorStyle.LLAMA_2 —
    '[INST] <<SYS>>\\n{system}\\n<</SYS>>\\n\\n{q} [/INST] {a} </s>'
    (the leading sep '<s>' is stripped exactly as the reference's
    ret.lstrip(sep) does)."""

    system: str
    roles: Tuple[str, str] = ("USER", "ASSISTANT")
    sep: str = " "
    sep2: str = "</s>"
    style: str = "two"
    messages: List[Tuple[str, str]] = field(default_factory=list)

    def append_message(self, role: str, message: str):
        self.messages.append((role, message))

    # The literal string preceding the answer text in the rendered
    # prompt — collate uses it to compute the exact label boundary.
    @property
    def answer_marker(self) -> str:
        return "[/INST] " if self.style == "llama_2" else \
            self.roles[1] + ": "

    def get_prompt(self) -> str:
        if self.style == "llama_2":
            out = ""
            for i, (role, message) in enumerate(self.messages):
                if not message:
                    continue
                if i == 0:
                    message = (f"<<SYS>>\n{self.system}\n<</SYS>>\n\n"
                               + message)
                if i % 2 == 0:
                    out += self.sep + f"[INST] {message} [/INST]"
                else:
                    out += " " + message + " " + self.sep2
            return out.lstrip(self.sep)
        seps = [self.sep, self.sep2]
        out = self.system + seps[0]
        for i, (role, message) in enumerate(self.messages):
            if message:
                out += role + ": " + message + seps[i % 2]
            else:
                out += role + ":"
        return out

    def copy(self) -> "Conversation":
        return Conversation(system=self.system, roles=self.roles,
                            sep=self.sep, sep2=self.sep2, style=self.style,
                            messages=list(self.messages))


CONV_LLAVA_V1 = Conversation(
    system="A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the human's questions.")

# Reference conversation.py conv_llava_llama_2 (the other --conv_type the
# reference trainer accepts, train_ds.py:115-119).
CONV_LLAVA_LLAMA_2 = Conversation(
    system="You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language.",
    sep="<s>", sep2="</s>", style="llama_2")

CONV_TEMPLATES = {
    "llava_v1": CONV_LLAVA_V1,
    "llava_llama_2": CONV_LLAVA_LLAMA_2,
}


def wrap_image_tokens(prompt: str, use_mm_start_end: bool = True) -> str:
    """<image> -> <im_start><image><im_end> (reference dataset.py:76-87)."""
    if use_mm_start_end:
        return prompt.replace(
            DEFAULT_IMAGE_TOKEN,
            DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN
            + DEFAULT_IM_END_TOKEN)
    return prompt


def build_conversation(question: str, answer: str = None,
                       conv_type: str = "llava_v1") -> str:
    conv = CONV_TEMPLATES[conv_type].copy()
    conv.append_message(conv.roles[0], question)
    conv.append_message(conv.roles[1], answer)
    return conv.get_prompt()
