"""Fixed QA data-generation sample list (a copy of ``ivosw_tpu/data/qa_samples.py``).

The 60 (DAVIS-train sequence, scribble index) pairs the reference pins for
quality-assessment data generation (``datasets/qa_samples.py:1-62``, injected
via ``sess.samples = samples`` in ``generate_data.py:129``). Pure fixture
data (public DAVIS 2017 sequence names), stored compactly.
"""

_NAMES = (
    "bear bmx-bumps boat boxing-fisheye breakdance-flare bus car-turn "
    "cat-girl classic-car color-run crossing dance-jump dancing disc-jockey "
    "dog-agility dog-gooses dogs-scale drift-turn drone elephant flamingo "
    "hike hockey horsejump-low kid-football kite-walk koala lady-running "
    "lindy-hop longboard lucia mallard-fly mallard-water miami-surf "
    "motocross-bumps motorbike night-race paragliding planes-water rallye "
    "rhino rollerblade schoolgirls scooter-board scooter-gray sheep "
    "skate-park snowboard soccerball stroller stunt surf swing tennis "
    "tractor-sand train tuk-tuk upside-down varanus-cage walking"
)

samples = [(name, 1) for name in _NAMES.split()]
