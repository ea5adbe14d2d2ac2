"""Scene -> prompt registry + negative prompts.

A copy of ``worldforge_tpu/utils/prompts.py`` (the port imports nothing of
the JAX package): model-facing data constants of the reference pipeline.
"""

from __future__ import annotations

from typing import List

SCENE_PROMPTS = {
    "horn": (
        "A bullet time effect video in a 3D photography style, where the entire museum exhibit is completely frozen in a single moment of time. A massive Triceratops skull is captured in a perfectly static, fixed display, its fossilized texture and imposing horns utterly motionless, as if suspended in time itself. The background, including the blurred outlines of other dinosaur exhibits, the structural elements of the museum, and the subtly textured floor, is absolutely motionless like a frozen three-dimensional image. The sole source of movement is the camera itself, which moves smoothly and stably in a gentle arc around the skull, capturing this prehistoric relic from a continuously shifting perspective to fully showcase the time-stopped setting."
    ),
    "null": "A bullet time effect video in a 3D photography style.",
    "smoke": (
        "Cinematic style. A heavyset Asian man in a striking plaid suit and dark sunglasses stands beside a light blue and a white taxi. He is lighting a cigarette with a silver lighter. A brief puff of smoke curls upwards. Once lit, he performs a swift, flamboyant flick of both hands outward to his sides, then smoothly places both hands into his suit pockets. In the background, near a building entrance with doorways and columns, several figures can be seen, including individuals who appear to be staff in uniform. The camera lens moves in a slow, steady arc around him."
    ),
    "truck": (
        "In a bullet time effect video with a 3D photography style, the entire urban street scene is completely frozen in a single moment of time. A vintage truck is captured in a perfectly static, silent state on a wide concrete sidewalk. Its light blue cab and chassis show a weathered patina, while the brown wooden planks of its cargo bed are held in absolute stillness; every detail, from the chipped paint to the texture of the wood grain, is rendered with sharp, unmoving clarity. The entire background is like a frozen three-dimensional image: the leaves on the city trees are perfectly still, with no hint of a breeze, and the surrounding street furniture, modern buildings, and even the manhole cover on the pavement are all locked in this silent, motionless moment. The only sense of dynamism comes from the implied camera, which moves smoothly and stably in a gentle arc around the scene, capturing this time-stopped moment from a continuously shifting perspective to fully showcase its bullet time setting."
    ),
    "Oil_painting": (
        "Oil painting photography in a bullet time effect video, this oil painting of Socrates' death is absolutely frozen in a single moment, every element suspended in time. Socrates sits motionless on his bed, one arm raised in a statically frozen gesture, his fingers unmoving, the other arm extended towards the hemlock, his hand and fingers also completely frozen. The figures around him are depicted in various frozen postures of sorrow and contemplation, their eyes fixed and unblinking, their arms and legs held in static poses. Every gesture, every expression, every limb – including all fingers and eyes – is utterly frozen, creating a completely fixed tableau within the scene of the oil painting. The texture of the paint, the unmoving folds of clothing, and the sharp, frozen shadows all reinforce the absolute stillness. The only dynamism in the video will be the slow, steady camera movement across this completely frozen scene."
    ),
    "fast": (
        "Realistic style. On a paved road flanked by dense green trees and a guardrail on the left, a red van is speeding forward, moving rapidly away from the lens. Following closely behind the red van is a silver car, maintaining a high speed. The camera moves backward quickly, retreating from the vehicles, while simultaneously and slowly rising upwards to transition into a high-angle overhead view, revealing more of the road and the surrounding forest environment."
    ),
}

NEGATIVE_PROMPT_STATIC = "Blink, twinkle, waggle, speak, wind, windy, leaves shaking, leaves tremble, sighboard, background dynamics, dynamic imagery, gray sky, hazy sky, overcast, gloomy sky, dim, murky, smoggy, shake, object motion blur, streaking objects, object jitter, camera shake, time flow, illogical composition, bright tones, overexposed, blurred details, subtitles, text, logo, overall gray, worst quality, low quality, JPEG compression residue, ugly, incomplete, sudden scene shift, incoherent scene jump, extra fingers, poorly drawn hands, poorly drawn faces, deformed, disfigured, misshapen limbs, fused fingers, any movement, character motion, slight object movement, object swaying, character micro-movements, subtle object rotation, object vibration, messy background, three legs, many people in the background, walking, scene changes, visual detail movement, object disintegration, object breakage."

NEGATIVE_PROMPT_DYNAMIC = "Streaking objects, mosaic, grainy, pixelated, noise, flickering, cropped, glitch, fragmented, broken, artifacts, chromatic aberration, micro camera shake, grid, tiling, blurry, camera shake, sudden scene shift, incoherent scene jump, sudden object appearance, blinking, object jitter, camera shake, illogical composition, bright tones, overexposed, blurred details, subtitles, overall gray, solid color, worst quality, low quality, JPEG compression residue, ugly, incomplete, extra fingers, poorly drawn hands, poorly drawn faces, deformed, disfigured, misshapen limbs, fused fingers, messy background, three legs, many people in the background, walking backwards"


def get_prompt(scene_name: str) -> str:
    if scene_name in SCENE_PROMPTS:
        return SCENE_PROMPTS[scene_name]
    print(f"Warning: Scene '{scene_name}' not found, using default prompt")
    return SCENE_PROMPTS["null"]


def get_negative_prompt(static: bool) -> str:
    return NEGATIVE_PROMPT_STATIC if static else NEGATIVE_PROMPT_DYNAMIC


def list_available_scenes() -> List[str]:
    return list(SCENE_PROMPTS.keys())
