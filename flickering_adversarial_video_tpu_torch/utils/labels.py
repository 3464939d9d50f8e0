"""Label maps: Kinetics-400, Kinetics-600 and UCF-101.

The port's own copy of the JAX package's ``utils/labels.py``, cut to what the
I3D runners use.  The reference keeps its label maps as line-per-class text
files; the Kinetics-400 class names are embedded here, and the Kinetics-600
and UCF-101 lists are the port's own copies of the JAX package's files
(``label_maps/label_map_600.txt``, ``label_maps/label_map_ucf_101.txt``), so
the package stands alone; an external file in the same format loads through
:func:`load_label_map`.
"""

from __future__ import annotations

import os
from typing import List, Optional

# Kinetics-400 class names (public dataset metadata; the order matches the
# DeepMind label map that the reference checkpoints use).
_KINETICS400 = """abseiling
air drumming
answering questions
applauding
applying cream
archery
arm wrestling
arranging flowers
assembling computer
auctioning
baby waking up
baking cookies
balloon blowing
bandaging
barbequing
bartending
beatboxing
bee keeping
belly dancing
bench pressing
bending back
bending metal
biking through snow
blasting sand
blowing glass
blowing leaves
blowing nose
blowing out candles
bobsledding
bookbinding
bouncing on trampoline
bowling
braiding hair
breading or breadcrumbing
breakdancing
brush painting
brushing hair
brushing teeth
building cabinet
building shed
bungee jumping
busking
canoeing or kayaking
capoeira
carrying baby
cartwheeling
carving pumpkin
catching fish
catching or throwing baseball
catching or throwing frisbee
catching or throwing softball
celebrating
changing oil
changing wheel
checking tires
cheerleading
chopping wood
clapping
clay pottery making
clean and jerk
cleaning floor
cleaning gutters
cleaning pool
cleaning shoes
cleaning toilet
cleaning windows
climbing a rope
climbing ladder
climbing tree
contact juggling
cooking chicken
cooking egg
cooking on campfire
cooking sausages
counting money
country line dancing
cracking neck
crawling baby
crossing river
crying
curling hair
cutting nails
cutting pineapple
cutting watermelon
dancing ballet
dancing charleston
dancing gangnam style
dancing macarena
deadlifting
decorating the christmas tree
digging
dining
disc golfing
diving cliff
dodgeball
doing aerobics
doing laundry
doing nails
drawing
dribbling basketball
drinking
drinking beer
drinking shots
driving car
driving tractor
drop kicking
drumming fingers
dunking basketball
dying hair
eating burger
eating cake
eating carrots
eating chips
eating doughnuts
eating hotdog
eating ice cream
eating spaghetti
eating watermelon
egg hunting
exercising arm
exercising with an exercise ball
extinguishing fire
faceplanting
feeding birds
feeding fish
feeding goats
filling eyebrows
finger snapping
fixing hair
flipping pancake
flying kite
folding clothes
folding napkins
folding paper
front raises
frying vegetables
garbage collecting
gargling
getting a haircut
getting a tattoo
giving or receiving award
golf chipping
golf driving
golf putting
grinding meat
grooming dog
grooming horse
gymnastics tumbling
hammer throw
headbanging
headbutting
high jump
high kick
hitting baseball
hockey stop
holding snake
hopscotch
hoverboarding
hugging
hula hooping
hurdling
hurling (sport)
ice climbing
ice fishing
ice skating
ironing
javelin throw
jetskiing
jogging
juggling balls
juggling fire
juggling soccer ball
jumping into pool
jumpstyle dancing
kicking field goal
kicking soccer ball
kissing
kitesurfing
knitting
krumping
laughing
laying bricks
long jump
lunge
making a cake
making a sandwich
making bed
making jewelry
making pizza
making snowman
making sushi
making tea
marching
massaging back
massaging feet
massaging legs
massaging person's head
milking cow
mopping floor
motorcycling
moving furniture
mowing lawn
news anchoring
opening bottle
opening present
paragliding
parasailing
parkour
passing American football (in game)
passing American football (not in game)
peeling apples
peeling potatoes
petting animal (not cat)
petting cat
picking fruit
planting trees
plastering
playing accordion
playing badminton
playing bagpipes
playing basketball
playing bass guitar
playing cards
playing cello
playing chess
playing clarinet
playing controller
playing cricket
playing cymbals
playing didgeridoo
playing drums
playing flute
playing guitar
playing harmonica
playing harp
playing ice hockey
playing keyboard
playing kickball
playing monopoly
playing organ
playing paintball
playing piano
playing poker
playing recorder
playing saxophone
playing squash or racquetball
playing tennis
playing trombone
playing trumpet
playing ukulele
playing violin
playing volleyball
playing xylophone
pole vault
presenting weather forecast
pull ups
pumping fist
pumping gas
punching bag
punching person (boxing)
push up
pushing car
pushing cart
pushing wheelchair
reading book
reading newspaper
recording music
riding a bike
riding camel
riding elephant
riding mechanical bull
riding mountain bike
riding mule
riding or walking with horse
riding scooter
riding unicycle
ripping paper
robot dancing
rock climbing
rock scissors paper
roller skating
running on treadmill
sailing
salsa dancing
sanding floor
scrambling eggs
scuba diving
setting table
shaking hands
shaking head
sharpening knives
sharpening pencil
shaving head
shaving legs
shearing sheep
shining shoes
shooting basketball
shooting goal (soccer)
shot put
shoveling snow
shredding paper
shuffling cards
side kick
sign language interpreting
singing
situp
skateboarding
ski jumping
skiing (not slalom or crosscountry)
skiing crosscountry
skiing slalom
skipping rope
skydiving
slacklining
slapping
sled dog racing
smoking
smoking hookah
snatch weight lifting
sneezing
sniffing
snorkeling
snowboarding
snowkiting
snowmobiling
somersaulting
spinning poi
spray painting
spraying
springboard diving
squat
sticking tongue out
stomping grapes
stretching arm
stretching leg
strumming guitar
surfing crowd
surfing water
sweeping floor
swimming backstroke
swimming breast stroke
swimming butterfly stroke
swing dancing
swinging legs
swinging on something
sword fighting
tai chi
taking a shower
tango dancing
tap dancing
tapping guitar
tapping pen
tasting beer
tasting food
testifying
texting
throwing axe
throwing ball
throwing discus
tickling
tobogganing
tossing coin
tossing salad
training dog
trapezing
trimming or shaving beard
trimming trees
triple jump
tying bow tie
tying knot (not on a tie)
tying tie
unboxing
unloading truck
using computer
using remote controller (not gaming)
using segway
vault
waiting in line
walking the dog
washing dishes
washing feet
washing hair
washing hands
water skiing
water sliding
watering plants
waxing back
waxing chest
waxing eyebrows
waxing legs
weaving basket
welding
whistling
windsurfing
wrapping present
wrestling
writing
yawning
yoga
zumba"""


def kinetics400_labels() -> List[str]:
    return _KINETICS400.split("\n")


def _read_label_map(name: str) -> List[str]:
    path = os.path.join(os.path.dirname(__file__), "label_maps", name)
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def kinetics600_labels() -> List[str]:
    """Kinetics-600 class names (the reference's data/label_map_600.txt,
    used with eval_type 'rgb600')."""
    return _read_label_map("label_map_600.txt")


def ucf101_labels() -> List[str]:
    """UCF-101 class names (the reference's data/label_map_ucf_101.txt)."""
    return _read_label_map("label_map_ucf_101.txt")


def labels_for_num_classes(num_classes: int) -> List[str]:
    """The dataset label map for a victim head of `num_classes`.  A head
    size without a public class list gets placeholder names, so that a
    TARGETED_CLASS lookup fails loudly and never resolves to another
    dataset's class index."""
    if num_classes == 400:
        return kinetics400_labels()
    if num_classes == 600:
        return kinetics600_labels()
    if num_classes == 101:
        return ucf101_labels()
    return [f"class_{i:03d}" for i in range(num_classes)]


def load_label_map(path: Optional[str] = None, num_classes: int = 400) -> List[str]:
    """A line-per-class label map file; the embedded map for `num_classes`
    when the path is missing."""
    if path:
        try:
            with open(path) as f:
                return [line.strip() for line in f if line.strip()]
        except OSError:
            pass
    return labels_for_num_classes(num_classes)


def warn_if_placeholder(labels: List[str]) -> bool:
    """Print a note when a label list is made of placeholder names (a head
    with no public class list, as the ig65m r2plus1d_34's 359/487 classes):
    results then name classes class_000, class_001, ..."""
    if labels and all(name == f"class_{i:03d}" for i, name in enumerate(labels[:3])):
        print(f"[labels] NOTE: no class list for a {len(labels)}-way head; class names in "
              f"results are placeholders class_000..class_{len(labels) - 1:03d}")
        return True
    return False
